"""The port's cluster serving plane on the CPU: replicated deployments on
cluster workers, failover when a worker is killed, and the cluster-atomic
two-phase cutover, held to the contract of the JAX package's
``tests/serving/test_cluster_serving.py`` case for case.

``serving_cluster = False`` or ``cluster_workers = 0`` keeps the
single-process path and never imports ``serving/cluster.py``. A routed
answer equals the in-process ModelServer's bit for bit (the same rung,
the same ``torch.get_num_threads()``); a replica killed mid-stream loses
no request (each is answered or fails classified, none hangs), with one
``serving_failover`` event per moved request; a draining worker finishes
what it holds and admits nothing new; a cutover or rollback never lets
two callers see mixed versions, and a failed prepare rolls back with v1
serving everywhere. Two parity cases add the JAX package's in-process
ModelServer on the same TestNet weights (float32, within
``1e-3·max|ref|``; the JAX cluster plane is never run) and a
worker-built model's state dict, ``torch.equal`` to the one built here.

The loaders and models the workers receive come from
``tests/torch_serving_ops.py`` (a worker imports the module of each
function it is sent; this module imports JAX). Tests share one 2-worker
router where their case allows (the process-wide router of
``maybe_router``, kept while its knobs hold; each uses a model name of
its own); a case that kills, drains or closes its router builds its own.
Every predict carries a deadline and every join, wait and subprocess is
bounded.
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu import serving as jax_serving
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.cluster import router as cluster_router
from sparkdl_tpu_torch.core import executor, health, resilience, telemetry
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
from sparkdl_tpu_torch.engine.dataframe import DataFrame, EngineConfig
from sparkdl_tpu_torch.serving import ModelRegistry, ModelServer
from sparkdl_tpu_torch.serving import cluster as serving_cluster
from tests import torch_serving_ops as ops
from tests.torch_port_helpers import headless, max_abs, random_variables

_ELEMENT = ops.ELEMENT
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a generous deadline: the chaos cases prove "no hang" through a
# classified DeadlineExceeded, never through a test timeout
_DEADLINE_MS = 60_000.0
JOIN_S = 120.0
F32_REL = 1e-3


@pytest.fixture(autouse=True)
def _cpu_engine():
    saved, jsaved = EngineConfig.snapshot(), JaxEngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    executor.reset()
    yield
    executor.reset()
    EngineConfig.restore(saved)
    JaxEngineConfig.restore(jsaved)


@pytest.fixture(scope="module", autouse=True)
def _no_worker_left():
    yield
    cluster_router.shutdown()
    serving_cluster.reset()
    deadline = time.monotonic() + 30
    while _cluster_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _cluster_children() == []


def _cluster_children():
    return [p.name for p in multiprocessing.active_children()
            if p.name.startswith("sparkdl-cluster")]


def _arm(workers: int = 2) -> None:
    EngineConfig.cluster_workers = workers
    EngineConfig.serving_cluster = True


def _fresh(workers: int = 2) -> None:
    """A router of its own for a case that kills, drains or closes it."""
    cluster_router.shutdown()
    serving_cluster.reset()
    _arm(workers)


def _stack():
    reg = ModelRegistry()
    return reg, ModelServer(reg)


def _router():
    r = cluster_router.maybe_router()
    assert r is not None
    return r


def _row(rng):
    return rng.normal(size=_ELEMENT).astype(np.float32)


# ---------------------------------------------------------------------------
# The gate: off means OFF
# ---------------------------------------------------------------------------


def test_single_process_serving_never_imports_cluster_serving():
    """``cluster_workers = 0`` (the default), with ``serving_cluster`` off
    and then on, keeps serving/cluster.py un-imported, not just unused:
    held in a subprocess, because this process imports it."""
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from tests import torch_serving_ops as ops\n"
        "from sparkdl_tpu_torch.engine.dataframe import EngineConfig\n"
        "from sparkdl_tpu_torch.serving import ModelRegistry, ModelServer\n"
        "EngineConfig.device = 'cpu'\n"
        "EngineConfig.inference_precision = 'float32'\n"
        "assert EngineConfig.cluster_workers == 0\n"
        "assert EngineConfig.serving_cluster is False\n"
        "reg = ModelRegistry(); srv = ModelServer(reg)\n"
        "reg.deploy('clf', 'v1', model=ops.toy(1.0))\n"
        "reg.deploy('clf', 'v2', model=ops.toy(2.0))\n"
        "row = np.ones(6, dtype='float32')\n"
        "assert srv.predict('clf', row).version == 'v1'\n"
        "EngineConfig.serving_cluster = True\n"
        "assert srv.predict('clf', row).version == 'v1'\n"
        "assert srv.cutover('clf', 'v2') == 'v1'\n"
        "assert srv.rollback('clf') == 'v2'\n"
        "assert 'cluster' not in srv.status()\n"
        "rogue = sorted(m for m in sys.modules if m.startswith("
        "'sparkdl_tpu_torch.cluster')\n"
        "               or m == 'sparkdl_tpu_torch.serving.cluster')\n"
        "assert not rogue, rogue\n"
        "assert not any(m.split('.')[0] in ('jax', 'sparkdl_tpu')\n"
        "               for m in sys.modules)\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=_REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=240)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, out[-3000:]
    assert "CLEAN" in out


# ---------------------------------------------------------------------------
# Replication, routing, the replica map (one shared router)
# ---------------------------------------------------------------------------


def test_cluster_predict_bit_identical_with_replica_map(rng):
    _fresh(2)  # the first case on this router: exactly one replica warms
    m = ops.toy(1.0)
    reg0, srv0 = _stack()  # the single-process answers first
    reg0.deploy("clf", "v1", model=m)
    row = _row(rng)
    batch = rng.normal(size=(5,) + _ELEMENT).astype(np.float32)
    ref_row = srv0.predict("clf", row).output
    ref_batch = srv0.predict("clf", batch).output

    reg, srv = _stack()
    reg.deploy("clf", "v1", model=m)
    got = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    assert got.version == "v1"
    np.testing.assert_array_equal(got.output, ref_row)
    got = srv.predict("clf", batch, deadline_ms=_DEADLINE_MS)
    np.testing.assert_array_equal(got.output, ref_batch)

    status = srv.status()["cluster"]
    assert status["clf"]["active"] == "v1"
    replicas = status["clf"]["replicas"]
    assert len(replicas) == 2
    for view in replicas.values():
        assert view["versions"] == ["v1"]
        assert set(view) == {"versions", "resident", "resident_bytes",
                             "inflight"}
    # locality: exactly one worker served (and is resident); the other
    # stayed cold, since routing prefers the hot replica
    resident = [w for w, v in replicas.items() if v["resident"]]
    assert len(resident) == 1
    assert replicas[resident[0]]["resident_bytes"] == m.weight_bytes()
    exported = telemetry.SnapshotExporter._serving_status()
    assert exported is not None and "clf" in exported["cluster"]
    assert exported["cluster"] == serving_cluster.exporter_status()


def test_cluster_answers_match_jax_model_server():
    """TestNet's flax weights, carried into the port by
    ``models/convert.py``: the cluster's answers (a row and a batch)
    against the JAX package's in-process ModelServer, float32."""
    JaxEngineConfig.inference_precision = "float32"
    _arm(2)
    jm = jax_testnet.TestNet(include_top=True)
    w = headless(random_variables(jm, (1, 32, 32, 3), seed=171))
    reg, srv = _stack()
    reg.deploy("tn", "v1", loader=ops.testnet_loader(weights=w),
               batch_size=4)
    jreg = jax_serving.ModelRegistry()
    jreg.deploy("tn", "v1", loader=lambda: jax_registry.build_featurizer(
        "TestNet", weights=w), batch_size=4)
    jsrv = jax_serving.ModelServer(jreg)
    rng = np.random.default_rng(173)
    row = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    for rows in (row, batch):
        got = srv.predict("tn", rows, deadline_ms=_DEADLINE_MS)
        want = np.asarray(jsrv.predict("tn", rows).output)
        assert got.version == "v1"
        assert got.output.shape == want.shape
        assert np.isfinite(got.output).all()
        assert max_abs(got.output, want) <= F32_REL * np.abs(want).max()


@pytest.mark.parametrize("source", ["seeded", "flax_weights"])
def test_worker_built_state_dict_equals_coordinators(source):
    """The deployment's loader (as the serving plane sends it, warm-up
    wrap and all) run in a cluster worker gives exactly the weights it
    gives here: each tensor ``torch.equal``."""
    _arm(2)
    if source == "seeded":
        loader = ops.testnet_loader(seed=5)
    else:
        jm = jax_testnet.TestNet(include_top=True)
        loader = ops.testnet_loader(weights=headless(
            random_variables(jm, (1, 32, 32, 3), seed=172)))
    reg = ModelRegistry()
    dep = reg.deploy("state_" + source, "v1", loader=loader)
    here = dep.model().variables.state_dict()
    frame = DataFrame.fromColumns({"x": np.arange(2, dtype=np.int64)},
                                  numPartitions=2)
    ran = sum(_router().results.values())
    rows = frame.withColumnBatch("state", ops.state_of(dep.loader)).collect()
    assert sum(_router().results.values()) - ran == 2  # both on workers
    for r in rows:
        there = r["state"]
        assert sorted(there) == sorted(here)
        for k, t in here.items():
            assert torch.equal(torch.from_numpy(there[k]), t), k


# ---------------------------------------------------------------------------
# Cluster-atomic hot swap (the shared router)
# ---------------------------------------------------------------------------


def test_cutover_is_cluster_atomic_no_version_mix(rng):
    """3 threads stream predicts across a live cutover: of any two
    requests where one STARTED after the other COMPLETED, the later one
    must not see the older version."""
    _arm(2)
    reg, srv = _stack()
    reg.deploy("swap", "v1", model=ops.toy(1.0))
    reg.deploy("swap", "v2", model=ops.toy(2.0))  # dark until cut over
    row = _row(rng)
    refs = {"v1": ops.reference(1.0, row[None])[0],
            "v2": ops.reference(2.0, row[None])[0]}
    srv.predict("swap", row, deadline_ms=_DEADLINE_MS)  # warm v1

    log = []  # (t_start, t_end, version)
    log_lock = threading.Lock()
    stop = threading.Event()
    fail = []

    def stream():
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                out = srv.predict("swap", row, deadline_ms=_DEADLINE_MS)
                np.testing.assert_array_equal(out.output,
                                              refs[out.version])
            except Exception as e:  # noqa: BLE001 - surfaced below
                fail.append(e)
                return
            with log_lock:
                log.append((t0, time.monotonic(), out.version))

    threads = [threading.Thread(target=stream, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_S
    while len(log) < 6 and not fail and time.monotonic() < deadline:
        time.sleep(0.01)  # let v1 traffic establish
    with HealthMonitor("swap") as mon:
        prev = srv.cutover("swap", "v2")
    assert prev == "v1"
    assert mon.count(health.SERVING_CUTOVER) == 1
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline and not fail:
        with log_lock:
            if sum(v == "v2" for _, _, v in log) >= 3:
                break
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a predict hung"
    assert not fail, fail
    with log_lock:
        snap = list(log)
    assert {v for _, _, v in snap} == {"v1", "v2"}
    first_v2_end = min(t1 for _, t1, v in snap if v == "v2")
    assert all(v == "v2" for t0, _, v in snap if t0 > first_v2_end), snap
    assert reg.active_version("swap") == "v2"


def test_direct_registry_cutover_adopted_cluster_atomically(rng):
    """A ``registry.cutover`` behind the router's back converges: the
    next predict sees the pointers differ and runs the SAME two-phase
    swap before it serves the new version."""
    _arm(2)
    reg, srv = _stack()
    reg.deploy("direct", "v1", model=ops.toy(1.0))
    reg.deploy("direct", "v2", model=ops.toy(2.0))
    row = _row(rng)
    assert srv.predict("direct", row,
                       deadline_ms=_DEADLINE_MS).version == "v1"
    reg.cutover("direct", "v2")  # direct, behind the router's back
    out = srv.predict("direct", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v2"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(2.0, row[None])[0])
    assert srv.status()["cluster"]["direct"]["active"] == "v2"


def test_rollback_is_cluster_atomic(rng):
    _arm(2)
    reg, srv = _stack()
    reg.deploy("roll", "v1", model=ops.toy(1.0))
    reg.deploy("roll", "v2", model=ops.toy(2.0))
    row = _row(rng)
    srv.predict("roll", row, deadline_ms=_DEADLINE_MS)
    with HealthMonitor("roll") as mon:
        assert srv.cutover("roll", "v2") == "v1"
        assert srv.predict("roll", row,
                           deadline_ms=_DEADLINE_MS).version == "v2"
        assert srv.rollback("roll") == "v2"
    assert mon.count(health.SERVING_CUTOVER) == 2
    out = srv.predict("roll", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v1"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(1.0, row[None])[0])
    assert reg.active_version("roll") == "v1"


def test_failed_prepare_rolls_back_v1_everywhere(rng):
    """One replica cannot load v2 (its loader raises in the worker whose
    name ends in ``-1``): prepare fails, the cutover rolls back, v1 stays
    active and answers on every replica, ``serving_prepare_failed`` is
    recorded once, and the shared router closes here with the report."""
    _arm(2)
    serving_cluster.reset()  # a serving router of its own on the cluster
    reg, srv = _stack()
    reg.deploy("prep", "v1", model=ops.toy(1.0))
    reg.deploy("prep", "v2", loader=ops.refusing_loader(2.0))
    row = _row(rng)
    srv.predict("prep", row, deadline_ms=_DEADLINE_MS)
    with HealthMonitor("prep") as mon:
        with pytest.raises(serving_cluster.CutoverFailed,
                           match="still serving everywhere"):
            srv.cutover("prep", "v2")
        assert mon.count(health.SERVING_PREPARE_FAILED) == 1
        assert mon.count(health.SERVING_CUTOVER) == 0  # nothing flipped
    assert reg.active_version("prep") == "v1"
    router = _router()
    each = serving_cluster.maybe_cluster_serving().predict_each(
        "prep", reg, row, deadline_ms=_DEADLINE_MS)
    assert len(each) == 2  # v1 answers on EVERY replica
    for out, version in each.values():
        assert version == "v1"
        np.testing.assert_array_equal(out, ops.reference(1.0, row[None])[0])
    for _ in range(4):
        out = srv.predict("prep", row, deadline_ms=_DEADLINE_MS)
        assert out.version == "v1"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(1.0, row[None])[0])
    router.close()
    section = router.cluster_report["serving"]["router"]
    assert section["prepare_failures"] == 1
    assert section["cutovers"] == 0
    assert section["deployments"]["prep"]["active"] == "v1"


def test_cutover_not_undone_by_a_predict_between_the_flips(rng):
    """The cluster commits first and the coordinator registry flips after
    it. A predict that reads the two pointers between the flips (the
    window held open by a hook in ``registry.cutover``) must not take the
    registry's old pointer for a direct cutover to adopt: it waits for
    the cutover and serves v2, and the cutover stays in place."""
    _arm(2)
    reg, srv = _stack()
    reg.deploy("race", "v1", model=ops.toy(1.0))
    reg.deploy("race", "v2", model=ops.toy(2.0))
    row = _row(rng)
    srv.predict("race", row, deadline_ms=_DEADLINE_MS)
    cluster = serving_cluster.maybe_cluster_serving()
    cutovers = cluster.report_section()["cutovers"]
    got, threads = [], []
    flip = reg.cutover

    def late_flip(name, version):
        # the cluster serves v2 now; the registry still says v1
        t = threading.Thread(target=lambda: got.append(srv.predict(
            "race", row, deadline_ms=_DEADLINE_MS)), daemon=True)
        t.start()
        threads.append(t)
        t.join(0.5)  # the predict reads the pointers inside the window
        return flip(name, version)

    reg.cutover = late_flip
    try:
        assert srv.cutover("race", "v2") == "v1"
    finally:
        del reg.cutover
    threads[0].join(JOIN_S)
    assert not threads[0].is_alive(), "the predict hung"
    assert [r.version for r in got] == ["v2"]
    np.testing.assert_array_equal(got[0].output,
                                  ops.reference(2.0, row[None])[0])
    assert reg.active_version("race") == "v2"
    assert cluster.status()["race"]["active"] == "v2"
    assert cluster.report_section()["cutovers"] == cutovers + 1
    out = srv.predict("race", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v2"


# ---------------------------------------------------------------------------
# The merged report (a router of its own)
# ---------------------------------------------------------------------------


def test_merged_report_carries_serving_sections(rng):
    _fresh(2)
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0))
    with telemetry.Telemetry("cluster_serving", out_dir="") as tel:
        for _ in range(3):
            srv.predict("clf", _row(rng), deadline_ms=_DEADLINE_MS)
        router = _router()
        router.close()
    section = router.cluster_report["serving"]
    # the workers' fold: every replica's stats, predicts summed
    assert section["predicts"] == 3
    assert section["replicas"]["clf"]["v1"]  # model -> version -> workers
    # the coordinator's block
    assert section["router"]["predicts"] == 3
    assert section["router"]["failovers"] == 0
    assert section["router"]["deployments"]["clf"]["active"] == "v1"
    assert router.run_report["serving"]["router"] == section["router"]
    assert tel.metrics.snapshot()["histograms"][
        telemetry.M_SERVING_REQUEST_S]["count"] == 3


# ---------------------------------------------------------------------------
# Chaos: kill -9 one replica mid-stream; a single replica killed
# ---------------------------------------------------------------------------


def test_kill_replica_mid_stream_loses_zero_requests(rng):
    """kill -9 one of 2 replicas while 3 threads stream predicts: every
    request completes within its deadline, the moved ones through
    failover (no hang, none lost, none failed); one ``serving_failover``
    event per moved request; the survivor's answers bit-identical to the
    single-process run; no process left behind."""
    _fresh(2)
    m = ops.toy(1.0)
    reg0, srv0 = _stack()
    reg0.deploy("clf", "v1", model=m)
    rows = rng.normal(size=(18,) + _ELEMENT).astype(np.float32)
    refs = [srv0.predict("clf", r).output for r in rows]

    reg, srv = _stack()
    reg.deploy("clf", "v1", model=m)
    # warm the routed replica, so the kill hits a hot path
    warm = srv.predict("clf", rows[0], deadline_ms=_DEADLINE_MS)
    np.testing.assert_array_equal(warm.output, refs[0])

    results = [None] * len(rows)
    errors = [None] * len(rows)
    start = threading.Barrier(4, timeout=JOIN_S)

    def run(idxs):
        start.wait()
        for i in idxs:
            try:
                results[i] = srv.predict("clf", rows[i],
                                         deadline_ms=_DEADLINE_MS).output
            except Exception as e:  # noqa: BLE001 - classified below
                errors[i] = e

    idxs = list(range(1, len(rows)))
    lanes = [idxs[k::3] for k in range(3)]
    with HealthMonitor("chaos") as mon:
        with FaultInjector.seeded(
                0, serving_worker_kill=Fault(times=1, after=3)) as inj:
            threads = [threading.Thread(target=run, args=(lanes[k],),
                                        daemon=True) for k in range(3)]
            for t in threads:
                t.start()
            start.wait()
            for t in threads:
                t.join(JOIN_S)
            assert not any(t.is_alive() for t in threads), \
                "a predict hung past its deadline"
    assert inj.fired == {"serving_worker_kill": 1}, inj.fired
    # none lost: the survivor holds v1 and every deadline is far off, so
    # the moved requests are answered too
    assert [e for e in errors if e is not None] == []
    for i in idxs:
        np.testing.assert_array_equal(results[i], refs[i])
    # exactly once: N moved requests, N serving_failover events, each a
    # distinct request id, and the router's ledger agrees
    events = mon.events(health.SERVING_FAILOVER)
    assert events, "the injected kill moved no request"
    moved_ids = [e["request"] for e in events]
    assert len(moved_ids) == len(set(moved_ids))
    router = _router()
    router.close()
    section = router.cluster_report["serving"]["router"]
    assert section["failovers"] == len(events)
    assert sorted(section["moved_requests"]) == sorted(moved_ids)
    assert mon.count(health.CLUSTER_WORKER_LOST) == 1
    cluster_router.shutdown()
    deadline = time.monotonic() + 30
    while _cluster_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _cluster_children() == []


def test_failover_exhausted_fails_classified_not_hung(rng):
    """With a single replica a killed worker cannot fail over: the
    request in flight fails RETRYABLE (ServingReplicaLost), fast and
    classified, never hung."""
    _fresh(1)
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0))
    row = _row(rng)
    srv.predict("clf", row, deadline_ms=_DEADLINE_MS)  # warm
    with HealthMonitor("solo") as mon:
        with FaultInjector.seeded(0, serving_worker_kill=1):
            t0 = time.monotonic()
            with pytest.raises(resilience.ServingReplicaLost):
                srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
            assert time.monotonic() - t0 < _DEADLINE_MS / 1e3 / 2
    assert resilience.classify(
        resilience.ServingReplicaLost("x")) == resilience.RETRYABLE
    assert mon.count(health.SERVING_FAILOVER) == 0  # nothing MOVED
    with pytest.raises(resilience.ServingReplicaLost,
                       match="no live replica"):  # no in-process fallback
        srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    cluster_router.shutdown()


def test_failover_budget_spent_fails_classified(rng):
    """``serving_failover_max = 0``: a request whose worker is killed is
    not moved, though a survivor holds the version; it fails with the
    classified ServingReplicaLost that names the spent budget, and the
    survivor goes on serving."""
    EngineConfig.serving_failover_max = 0
    _fresh(2)
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0))
    row = _row(rng)
    srv.predict("clf", row, deadline_ms=_DEADLINE_MS)  # warm
    with HealthMonitor("budget") as mon:
        with FaultInjector.seeded(0, serving_worker_kill=1):
            with pytest.raises(resilience.ServingReplicaLost,
                               match=r"failover budget \(0\) is spent"):
                srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
        assert mon.count(health.SERVING_FAILOVER) == 0
        assert mon.count(health.CLUSTER_WORKER_LOST) == 1
    out = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v1"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(1.0, row[None])[0])
    assert serving_cluster.maybe_cluster_serving().report_section()[
        "failovers"] == 0
    cluster_router.shutdown()


# ---------------------------------------------------------------------------
# Drain: stop admitting, finish what is in flight
# ---------------------------------------------------------------------------


def test_draining_worker_stops_admitting_but_finishes_inflight(rng):
    _fresh(2)
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0))
    row = _row(rng)
    first = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    router = _router()
    # SIGTERM the worker that just served (the hot replica): it drains,
    # finishing what it holds and taking no new predict, while the
    # stream goes on on the survivor
    replicas = srv.status()["cluster"]["clf"]["replicas"]
    hot_name = next(w for w, v in replicas.items() if v["resident"])
    with HealthMonitor("drain") as mon:
        hot = next(w for w in router._workers
                   if w.proc.name == hot_name and w.proc.is_alive())
        os.kill(hot.proc.pid, signal.SIGTERM)
        deadline = time.monotonic() + 60
        while hot.wid in router.serving_live_workers() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hot.wid not in router.serving_live_workers(), \
            "draining worker still admitting"
        for _ in range(6):
            out = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
            assert out.version == "v1"
        np.testing.assert_array_equal(out.output, first.output)
        # a drain is not a death: nothing moved, nothing lost
        assert mon.count(health.SERVING_FAILOVER) == 0
        assert mon.count(health.CLUSTER_WORKER_LOST) == 0
        assert mon.count(health.CLUSTER_WORKER_DRAINING) == 1
        # the preemption drain spawns a replacement, and the spawn's
        # top-up fans the deployment out to it: the replica map regains
        # its replication factor with no operator action
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            live = router.serving_live_workers()
            status = srv.status()["cluster"]["clf"]["replicas"]
            if len(live) >= 2 and len(status) >= 2 \
                    and all(s["versions"] == ["v1"]
                            for s in status.values()):
                break
            time.sleep(0.05)
        assert len(router.serving_live_workers()) >= 2
        assert len(srv.status()["cluster"]["clf"]["replicas"]) >= 2
        hot.proc.join(60)
        assert not hot.proc.is_alive(), "the drained worker did not exit"
    cluster_router.shutdown()


# ---------------------------------------------------------------------------
# Bucket-ladder warm-up across the cluster
# ---------------------------------------------------------------------------


def test_cluster_prepare_warms_ladder_on_every_replica(rng):
    """srv_prepare loads through the warm-up-wrapped loader: when a
    cutover commits, EVERY replica has captured the incoming version's
    ladder, one ``warmup_completed`` per (replica, version) cold load,
    federated into the merged cluster report."""
    EngineConfig.serving_warmup = True  # BEFORE the router spawns: the
    _fresh(2)                           # workers boot with it
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0), batch_size=8)
    row = _row(rng)
    # the first predict: ONE replica cold-loads (and warms) v1
    assert srv.predict("clf", row, deadline_ms=_DEADLINE_MS).version \
        == "v1"
    reg.deploy("clf", "v2", loader=ops.toy_loader(2.0), batch_size=8)
    srv.cutover("clf", "v2")  # two-phase: prepare warms BOTH replicas
    out = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v2"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(2.0, row[None])[0])
    router = _router()
    router.close()
    rep = router.cluster_report
    per_worker = {
        name: snap["health"]["counters"].get(health.WARMUP_COMPLETED, 0)
        for name, snap in rep["workers"].items()}
    assert len(per_worker) == 2
    # v2 prepared (= warmed) on BOTH replicas before the commit; v1 warmed
    # only on the replica that served the first request
    assert all(count >= 1 for count in per_worker.values()), per_worker
    assert sum(per_worker.values()) == 3, per_worker
    assert rep["health"]["counters"][health.WARMUP_COMPLETED] == 3
    assert rep["health_consistent"]


def test_cluster_failed_warmup_nacks_prepare_and_rolls_back(rng):
    """The warm-up gate has teeth: v2's loader succeeds on every replica
    but its ladder cannot run, so with serving_warmup armed the cold load
    fails DURING warm-up, the prepare nacks, and the cutover rolls back
    with v1 serving everywhere."""
    EngineConfig.serving_warmup = True
    _fresh(2)
    reg, srv = _stack()
    reg.deploy("clf", "v1", model=ops.toy(1.0), batch_size=8)
    reg.deploy("clf", "v2", loader=ops.dud_loader, batch_size=8)
    row = _row(rng)
    srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    with HealthMonitor("warm-prep") as mon:
        with pytest.raises(serving_cluster.CutoverFailed,
                           match="still serving everywhere"):
            srv.cutover("clf", "v2")
        assert mon.count(health.SERVING_PREPARE_FAILED) >= 1
        assert mon.count(health.SERVING_CUTOVER) == 0
    assert reg.active_version("clf") == "v1"
    out = srv.predict("clf", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v1"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(1.0, row[None])[0])
    router = _router()
    router.close()
    section = router.cluster_report["serving"]["router"]
    assert section["cutovers"] == 0
    assert section["prepare_failures"] >= 1
    assert section["deployments"]["clf"]["active"] == "v1"
    cluster_router.shutdown()
    serving_cluster.reset()


def test_worker_residency_budget_evicts_and_reloads(rng):
    """``serving_worker_residency_bytes`` holds two toy models on each
    replica: the cutovers v1 → v2 → v3 evict the unpinned v1 where it was
    resident, the cutover back to v1 evicts v2 and reloads v1 cold, and
    retiring v3 evicts it everywhere. The workers' final stats and
    health counters show it."""
    m = ops.toy(1.0)
    EngineConfig.serving_worker_residency_bytes = (
        2 * m.weight_bytes() + m.weight_bytes() // 2)
    _fresh(2)  # the workers boot with the budget
    reg, srv = _stack()
    for version, scale in (("v1", 1.0), ("v2", 2.0), ("v3", 3.0)):
        reg.deploy("res", version, model=ops.toy(scale))
    row = _row(rng)
    # one replica loads v1; each prepare below loads on both
    assert srv.predict("res", row, deadline_ms=_DEADLINE_MS).version == "v1"
    with HealthMonitor("budget") as mon:
        assert srv.cutover("res", "v2") == "v1"  # v1 + v2 fit
        assert srv.cutover("res", "v3") == "v2"  # v1 evicted where loaded
        assert srv.cutover("res", "v1") == "v3"  # v2 evicted, v1 reloaded
    out = srv.predict("res", row, deadline_ms=_DEADLINE_MS)
    assert out.version == "v1"
    np.testing.assert_array_equal(out.output,
                                  ops.reference(1.0, row[None])[0])
    serving_cluster.maybe_cluster_serving().retire("res", "v3")
    router = _router()
    router.close()
    rep = router.cluster_report
    cold = {w: snap["health"]["counters"].get(health.SERVING_COLD_START, 0)
            for w, snap in rep["workers"].items()}
    evicted = {w: snap["health"]["counters"].get(health.SERVING_EVICTED, 0)
               for w, snap in rep["workers"].items()}
    # the replica that served v1 first: v1, v2, v3, v1 loaded and v1, v2,
    # v3 evicted; the other: v2, v3, v1 loaded and v2, v3 evicted
    assert sorted(cold.values()) == [3, 4], cold
    assert sorted(evicted.values()) == [2, 3], evicted
    assert mon.count(health.SERVING_CUTOVER) == 3
    for w, view in rep["serving"]["workers"].items():
        assert view["resident_bytes"] == m.weight_bytes(), (w, view)
        assert {(d["model"], d["version"], d["resident"])
                for d in view["deployments"]} == {
            ("res", "v1", True), ("res", "v2", False)}, (w, view)
    cluster_router.shutdown()


def test_cluster_names_resolve_lazily():
    from sparkdl_tpu_torch import serving

    assert serving.ClusterServingRouter is \
        serving_cluster.ClusterServingRouter
    assert serving.CutoverFailed is serving_cluster.CutoverFailed
    assert serving.WorkerServingPlane is serving_cluster.WorkerServingPlane
    assert {"ClusterServingRouter", "CutoverFailed",
            "WorkerServingPlane"} <= set(serving.__all__)
    with pytest.raises(AttributeError):
        serving.NoSuchName  # noqa: B018
