"""The port's cluster inference plane on the CPU: the partition router,
its worker processes, the merged reports, the federation fold and the
autoscaler, against the port's own in-process path (and, for the
featurize slice, the JAX package's featurizer).

Rows computed on 2 spawned workers must be ``np.array_equal`` to the
same frame computed in this process. The ops shipped to the workers
come from ``tests/torch_cluster_ops.py`` (a worker imports the module
of each function it is sent; this module imports JAX).

One router serves the first tests of this file (the process-wide
router of ``maybe_router``, kept while its knobs hold); the tests after
``test_shared_router_report_proves_health_sums`` each build the router
their case needs. Every wait here is bounded.
"""

import glob
import json
import multiprocessing
import os
import threading
import time
import types

import numpy as np
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.cluster import aggregate
from sparkdl_tpu_torch.cluster import router as cluster_router
from sparkdl_tpu_torch.cluster import transport
from sparkdl_tpu_torch.core import executor, health, resilience, slo, \
    telemetry
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
from sparkdl_tpu_torch.core.telemetry import Telemetry
from sparkdl_tpu_torch.engine.dataframe import Batch, DataFrame, EngineConfig
from sparkdl_tpu_torch.engine.supervisor import TaskFailure
from sparkdl_tpu_torch.image import imageIO
from tests import torch_cluster_ops as ops
from tests.torch_port_helpers import (
    frames, headless, max_abs, random_variables,
)

F32_REL = 1e-3
N_IMAGES, PARTS = 12, 6
_SPAN_S = 5.0
#: health events the shared router's ops record, by the tests that ran
_PROBES = {"count": 0}


def _engine_defaults():
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 3


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    _engine_defaults()
    yield
    EngineConfig.restore(saved)
    executor.reset()


@pytest.fixture(scope="module", autouse=True)
def no_router_left():
    yield
    cluster_router.shutdown()
    names = [p.name for p in multiprocessing.active_children()]
    assert not any(n.startswith("sparkdl-cluster") for n in names), names


def _wait_for(pred, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _await(router, task, timeout_s=60.0):
    """``router._await`` bounded: past ``timeout_s`` the attempt is
    abandoned and raises, rather than the test hanging."""
    give_up = threading.Event()
    timer = threading.Timer(timeout_s, give_up.set)
    timer.start()
    try:
        return router._await(task, give_up)
    finally:
        timer.cancel()


def _cols(batches, name):
    return [np.asarray(b.column(name)) for b in batches]


def _assert_no_live_workers(router):
    for w in router._workers:
        w.proc.join(timeout=10)
        assert not w.proc.is_alive()
    assert router._pending == {}


# -- the gate ----------------------------------------------------------------

def test_workers_zero_is_inline_and_routerless():
    assert EngineConfig.cluster_workers == 0
    assert cluster_router.maybe_router() is None
    got = ops.frame(8, 2).withColumnBatch("y", ops.probe()).collect()
    assert len(got) == 8
    assert cluster_router._router is None  # the run armed nothing


def test_maybe_router_validates_knobs_at_the_read_site():
    EngineConfig.cluster_workers = -1
    with pytest.raises(ValueError, match="cluster_workers"):
        cluster_router.maybe_router()
    EngineConfig.cluster_workers = 2
    EngineConfig.cluster_inflight_partitions = 0
    with pytest.raises(ValueError, match="cluster_inflight_partitions"):
        cluster_router.maybe_router()
    EngineConfig.cluster_inflight_partitions = None
    EngineConfig.autoscale_queue_wait_low_s = 1.0
    with pytest.raises(ValueError, match="hysteresis"):
        cluster_router.maybe_router()
    EngineConfig.autoscale_queue_wait_low_s = 0.05
    EngineConfig.job_tenant = ""
    with pytest.raises(ValueError, match="job_tenant"):
        cluster_router.maybe_router()
    assert cluster_router._router is None


# -- the shared router: parity ----------------------------------------------

@pytest.fixture(scope="module")
def variables():
    return random_variables(jax_testnet.TestNet(include_top=True),
                            (1, 32, 32, 3), seed=81)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(82)
    return [rng.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
            for _ in range(N_IMAGES)]


def _image_frame(images):
    return DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(
            images, [f"img{i}" for i in range(len(images))])},
        numPartitions=PARTS)


def _features(rows):
    return np.stack([np.asarray(r["features"], np.float32) for r in rows])


def test_cluster_featurize_equals_in_process_and_reference(variables,
                                                            images):
    feat = sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="TestNet",
        weights=headless(variables), batchSize=8)
    want = _features(feat.transform(_image_frame(images)).collect())
    want_stream = [np.stack(b.column("features")) for b in
                   feat.transform(_image_frame(images)).streamPartitions()]
    EngineConfig.cluster_workers = 2
    with HealthMonitor() as mon:
        got = _features(feat.transform(_image_frame(images)).collect())
        got_stream = [np.stack(b.column("features")) for b in
                      feat.transform(_image_frame(images))
                      .streamPartitions()]
    assert np.array_equal(got, want)
    assert len(got_stream) == PARTS
    for g, w in zip(got_stream, want_stream):
        assert np.array_equal(g, w)
    assert mon.count(health.TASK_STARTED) == 2 * PARTS
    assert mon.count(health.CLUSTER_WORKER_STARTED) == 2
    # the slice against the JAX package's featurizer of the same weights
    jdf, _ = frames(images, [f"img{i}" for i in range(N_IMAGES)])
    jdf = sparkdl_tpu.DataFrame.fromArrow(jdf.toArrow(), numPartitions=PARTS)
    ref = np.stack([np.asarray(r["features"], np.float32) for r in
                    sparkdl_tpu.DeepImageFeaturizer(
                        inputCol="image", outputCol="features",
                        modelName="TestNet", weights=headless(variables),
                        batchSize=8).transform(jdf).collect()])
    assert max_abs(got, ref) <= F32_REL * np.abs(ref).max()


def test_cluster_bit_identical_with_captured_tensor():
    want = ops.frame().withColumnBatch("y", ops.probe()).collect()
    want_stream = list(ops.frame().withColumnBatch(
        "y", ops.probe()).streamPartitions())
    EngineConfig.cluster_workers = 2
    got = ops.frame().withColumnBatch("y", ops.probe()).collect()
    got_stream = list(ops.frame().withColumnBatch(
        "y", ops.probe()).streamPartitions())
    _PROBES["count"] += 8
    assert [r["y"] for r in got] == [r["y"] for r in want]
    for g, w in zip(_cols(got_stream, "y"), _cols(want_stream, "y")):
        assert np.array_equal(g, w)


def test_remote_errors_keep_their_classification(tmp_path):
    EngineConfig.cluster_workers = 2
    marker = str(tmp_path / "fired-once")
    with HealthMonitor() as mon:
        got = ops.frame(8, 2).withColumnBatch(
            "y", ops.flaky(marker, "retryable")).collect()
    assert [r["y"] for r in got] == [i + 1 for i in range(8)]
    assert os.path.exists(marker)
    assert mon.count(health.TASK_RETRIED) == 1
    assert mon.count(health.TASK_FAILED) == 0
    with HealthMonitor() as mon:
        with pytest.raises(TaskFailure, match="fatal"):
            ops.frame(8, 2).withColumnBatch(
                "y", ops.flaky(marker, "fatal")).collect()
    assert mon.count(health.TASK_RETRIED) == 0  # FATAL: never retried
    assert mon.count(health.TASK_FAILED) == 1


def test_hedge_antiaffinity_and_load_aware_spread():
    EngineConfig.cluster_workers = 2
    router = cluster_router.maybe_router()
    token = router._ops_payload([ops.sleeping(0.5)])
    batch = Batch({"x": np.array([1, 2, 3])}, 3)
    # two attempts of the SAME partition (a hedge) land apart
    t1 = router._submit(7, batch, token)
    t2 = router._submit(7, batch, token)
    assert t1.worker != t2.worker
    for t in (t1, t2):
        assert np.array_equal(_await(router, t).column("x"), [1, 2, 3])
    # with one partition outstanding on a worker, the next goes to the
    # idle one
    t3 = router._submit(8, batch, token)
    t4 = router._submit(9, batch, token)
    assert t3.worker != t4.worker
    _await(router, t3)
    _await(router, t4)


def test_unshippable_op_raises_naming_it_and_never_runs_here():
    EngineConfig.cluster_workers = 2
    lock = threading.Lock()
    ran = []

    def op(batch):  # closes over a lock: cannot be pickled
        with lock:
            ran.append(1)
        return batch.column("x")

    with pytest.raises(transport.OpNotShippable, match="cannot ship op 0"):
        ops.frame(8, 2).withColumnBatch("y", op).collect()
    assert ran == []
    with pytest.raises(transport.OpNotShippable, match="op 1"):
        transport.dumps_ops([ops.probe(), op])


def test_durable_journal_composes_with_cluster(tmp_path):
    EngineConfig.cluster_workers = 2
    EngineConfig.durable_dir = str(tmp_path / "durable")
    trace = str(tmp_path / "executions.log")
    want = ops.frame(12, 4).withColumnBatch(
        "y", ops.plus_one_logged(trace)).collect()
    assert len(open(trace).read().splitlines()) == 4
    with HealthMonitor() as mon:
        got = ops.frame(12, 4).withColumnBatch(
            "y", ops.plus_one_logged(trace)).collect()
    assert got == want
    assert len(open(trace).read().splitlines()) == 4  # zero recompute
    assert mon.count(health.DURABLE_PARTITION_RESTORED) == 4


def test_op_chain_token_follows_the_ops_not_the_list():
    """Two chains whose fingerprints match (a captured tensor adds only
    its dtype and shape) get their own tokens, even in one list object:
    the router never hands a worker the weights of another chain."""
    EngineConfig.cluster_workers = 2
    router = cluster_router.maybe_router()
    chain = [ops.probe(seed=5)]
    first = router._ops_payload(chain)
    assert router._ops_payload(chain) == first  # a hit: no new pickle
    chain[0] = ops.probe(seed=6)
    second = router._ops_payload(chain)
    assert second != first
    assert second.rsplit(".", 1)[0] == first.rsplit(".", 1)[0]


def test_two_models_of_one_architecture_keep_their_weights(images):
    feats = [sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="TestNet",
        weights=headless(random_variables(
            jax_testnet.TestNet(include_top=True), (1, 32, 32, 3),
            seed=seed)), batchSize=8) for seed in (91, 92)]
    want = [_features(f.transform(_image_frame(images)).collect())
            for f in feats]
    assert not np.array_equal(*want)
    EngineConfig.cluster_workers = 2
    for f, w in zip(feats, want):
        assert np.array_equal(
            _features(f.transform(_image_frame(images)).collect()), w)


def test_device_sections_count_one_pass():
    EngineConfig.cluster_workers = 2
    router = cluster_router.maybe_router()
    before = router.device_sections()
    assert sorted(before) == sorted(w.proc.name for w in router._workers)
    ops.frame().withColumnBatch("y", ops.probe()).collect()
    _PROBES["count"] += 4
    after = router.device_sections()
    assert set(after) == set(before)
    for name, dev in after.items():
        assert dev["launches"] == before[name]["launches"]  # the CPU
        assert dev["boot"] == before[name]["boot"]


def test_shared_router_report_proves_health_sums():
    EngineConfig.cluster_workers = 2
    router = cluster_router.maybe_router()
    assert router is not None and not router.closed
    with HealthMonitor() as mon, Telemetry(out_dir="") as tel:
        got = ops.frame().withColumnBatch("y", ops.probe()).collect()
        _PROBES["count"] += 4
        cluster_router.shutdown()
    assert len(got) == 24
    assert mon.count(health.CLUSTER_WORKER_LOST) == 0
    rep = cluster_router.last_cluster_report()
    assert rep["worker_count"] == 2
    manual = {}
    for snap in rep["workers"].values():
        for name, value in snap["health"]["counters"].items():
            manual[name] = manual.get(name, 0) + value
    assert rep["health"]["counters"] == manual
    assert manual["cluster_probe"] == _PROBES["count"]
    assert rep["health_consistent"] is True
    # the workers' forwards and launch counts sum into one section (the
    # TestNet test ran 2 × 6 partitions, each one forward on a worker)
    assert rep["device"]["forwards"] >= 2 * PARTS
    assert sum(rep["device"]["launches"].values()) == 0  # the CPU
    for snap in rep["workers"].values():
        boot = snap["device"]["boot"]
        assert boot["spawn_s"] > 0 and boot["ready_s"] >= boot["spawn_s"]
        assert snap["device"]["memory_reserved"] is None  # no card
    # built outside any telemetry scope: no span rings, no federation
    assert "trace" not in rep and "federation" not in rep
    run_report = cluster_router.last_run_report()
    assert run_report["run_id"] == tel.run_id
    assert run_report["cluster"]["worker_count"] == 2
    _assert_no_live_workers(router)


# -- routers of their own ----------------------------------------------------

def test_worker_kill_redispatches_precisely_with_journal_trace_and_fold(
        tmp_path):
    """One ``cluster_worker_kill`` with the journal, tracing and
    federation armed: one worker lost, each of its in-flight partitions
    re-dispatched once, every partition executed exactly once, the rows
    those of the in-process run; the merged trace names the survivor
    and accounts the lost ring; the fold ages the dead worker out and
    the postmortem keeps its last frame."""
    trace = str(tmp_path / "executions.log")
    want = ops.frame(36, 6).withColumnBatch(
        "y", ops.plus_one_logged(trace)).collect()
    os.remove(trace)
    EngineConfig.cluster_workers = 2
    EngineConfig.cluster_federation_s = 0.04
    EngineConfig.durable_dir = str(tmp_path / "durable")
    out = str(tmp_path / "tel")
    inj = FaultInjector.seeded(0, cluster_worker_kill=Fault(times=1,
                                                            after=2))
    with HealthMonitor() as mon, \
            Telemetry(name="kill", out_dir=out) as tel:
        try:
            with inj:
                # each task outlives the frame cadence: both workers ship
                # a frame before the kill
                got = ops.frame(36, 6).withColumnBatch(
                    "y", ops.plus_one_logged(trace, 0.1)).collect()
        finally:
            cluster_router.shutdown()
    assert inj.fired == {"cluster_worker_kill": 1}
    assert got == want
    runs = sorted(int(x) for x in open(trace).read().split())
    assert runs == [6 * i for i in range(6)]  # each partition once
    assert mon.count(health.CLUSTER_WORKER_LOST) == 1
    moved = [e["partition"] for e in mon.events(health.CLUSTER_REDISPATCH)]
    (lost,) = mon.events(health.CLUSTER_WORKER_LOST)
    assert len(moved) == len(set(moved)) == lost["in_flight"] > 0
    dead = lost["worker"]
    router = cluster_router._last_router
    _assert_no_live_workers(router)
    rep = cluster_router.last_cluster_report()
    # the router's own count: each partition's result arrived once
    assert sum(rep["results"]["per_worker"].values()) == 6
    assert rep["results"]["late"] == 0
    assert rep["worker_count"] == 1
    assert rep["trace"]["span_rings_lost"] == [dead]
    # the merged trace: worker task spans under their dispatch spans,
    # up to the run's root, each carrying the worker's pid
    spans = {s["span_id"]: s for s in tel.tracer.spans()}
    tasks = [s for s in spans.values()
             if s["name"] == telemetry.SPAN_CLUSTER_TASK]
    assert tasks and all(s["pid"] != os.getpid() for s in tasks)
    for s in tasks:
        parent = spans[s["parent_id"]]
        assert parent["name"] == telemetry.SPAN_CLUSTER_DISPATCH
        while parent.get("parent_id") in spans:
            parent = spans[parent["parent_id"]]
        assert parent["name"] == telemetry.SPAN_RUN
    with open(tel.trace_path) as f:
        doc = json.load(f)
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "process_name"}
    assert "coordinator" in names
    assert any(n.startswith("sparkdl-cluster-") for n in names)
    # the federation fold aged the dead worker out, once
    (stale,) = mon.events(health.CLUSTER_METRICS_STALE)
    assert stale["worker"] == dead and stale["reason"] == "worker_lost"
    (bundle,) = glob.glob(os.path.join(out, "postmortem_*"))
    with open(os.path.join(bundle, "breach.json")) as f:
        bj = json.load(f)
    assert bj["trigger"] == "worker_lost"
    assert bj["federation"][dead]["alive"] is False


def test_no_survivors_fails_retryable():
    router = cluster_router.ClusterRouter(workers=1)
    try:
        token = router._ops_payload([ops.sleeping(0.0)])
        batch = Batch({"x": np.array([1, 2, 3])}, 3)
        with FaultInjector.seeded(0, cluster_worker_kill=1):
            task = router._submit(0, batch, token)
            with pytest.raises(resilience.ClusterWorkerLost) as ei:
                _await(router, task)
        assert resilience.classify(ei.value) == resilience.RETRYABLE
        with pytest.raises(resilience.ClusterWorkerLost):
            router._submit(1, batch, token)
    finally:
        router.close()
    _assert_no_live_workers(router)


def test_preemption_drains_gracefully_with_zero_recompute(tmp_path):
    trace = str(tmp_path / "executions.log")
    want = ops.frame(36, 6).withColumnBatch(
        "y", ops.plus_one_logged(trace)).collect()
    os.remove(trace)
    EngineConfig.durable_dir = str(tmp_path / "durable")
    EngineConfig.cluster_workers = 2
    inj = FaultInjector.seeded(0, cluster_worker_preempt=Fault(times=1,
                                                               after=2))
    try:
        with inj, HealthMonitor() as mon:
            got = ops.frame(36, 6).withColumnBatch(
                "y", ops.plus_one_logged(trace)).collect()
            _wait_for(lambda: mon.count(health.CLUSTER_WORKER_DRAINED) == 1,
                      "the preempted worker to drain")
    finally:
        cluster_router.shutdown()
    assert inj.fired == {"cluster_worker_preempt": 1}
    assert got == want
    assert len(open(trace).read().splitlines()) == 6  # zero recompute
    assert mon.count(health.CLUSTER_WORKER_LOST) == 0
    assert mon.count(health.CLUSTER_REDISPATCH) == 0
    assert mon.count(health.CLUSTER_WORKER_DRAINING) == 1
    assert mon.count(health.CLUSTER_WORKER_STARTED) == 3  # a replacement
    rep = cluster_router.last_cluster_report()
    assert rep["worker_count"] == 3
    assert sum(rep["tasks_per_worker"].values()) == 6
    assert rep["autoscale"]["drained"] == 1


def _live(router):
    with router._lock:
        return [w for w in router._workers
                if not w.lost and not w.finished and not w.draining]


def test_autoscale_tick_on_a_fake_clock(monkeypatch):
    """The autoscaler's decisions, each tick driven by hand at a given
    time with the windows read on a fake clock: up on a hot p99, none at
    the ceiling or inside the cooldown, a draining worker gets no new
    work, down when cold, none at the floor."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(telemetry, "_monotonic", lambda: clock["t"])
    EngineConfig.cluster_autoscale = True
    EngineConfig.cluster_min_workers = 1
    EngineConfig.cluster_max_workers = 2
    EngineConfig.autoscale_cooldown_s = 10.0
    with HealthMonitor() as mon:
        router = cluster_router.ClusterRouter(workers=1)
        router._autoscale_stop.set()
        router._autoscale_thread.join(timeout=10)
        assert not router._autoscale_thread.is_alive()
        try:
            with Telemetry(out_dir="") as tel:
                for _ in range(8):
                    telemetry.observe(telemetry.M_QUEUE_WAIT_S, 1.0)
                assert router.autoscale_tick(now=100.0) == "up"
                assert len(_live(router)) == 2
                assert tel.metrics.snapshot()["gauges"][
                    telemetry.M_CLUSTER_WORKERS] == 2
                assert router.autoscale_tick(now=200.0) is None  # ceiling
                EngineConfig.cluster_max_workers = 3
                assert router.autoscale_tick(now=105.0) is None  # cooldown
                EngineConfig.cluster_max_workers = 2
                # a draining worker takes no new work
                token = router._ops_payload([ops.sleeping(0.0)])
                batch = Batch({"x": np.array([1])}, 1)
                a, b = _live(router)
                with router._lock:
                    a.draining = True
                t = router._submit(0, batch, token)
                assert t.worker == b.wid
                _await(router, t)
                with router._lock:
                    a.draining = False
                clock["t"] += 120.0  # the hot samples leave the window
            assert router.autoscale_tick(now=300.0) == "down"
            _wait_for(lambda: mon.count(health.CLUSTER_WORKER_DRAINED) == 1,
                      "the idle worker to drain")
            assert len(_live(router)) == 1
            assert router.autoscale_tick(now=400.0) is None  # the floor
        finally:
            router.close()
    assert [e["action"] for e in router.autoscale_events] == [
        "spawn", "draining", "drained"]
    auto = router.cluster_report["autoscale"]
    assert (auto["scale_ups"], auto["scale_downs"], auto["drained"]) \
        == (1, 1, 1)


def test_aggregate_breach_fires_live_and_dumps_a_postmortem(
        tmp_path, monkeypatch):
    """No worker breaches the queue-wait rule alone; the merged fold
    does, live: one breach and one recovery, the breach naming both
    workers' values under the threshold, a bundle on disk mid-run."""
    monkeypatch.setattr(
        cluster_router, "_default_federation_rules",
        lambda: [r for r in slo.federated_default_rules(window_s=5.0)
                 if r.metric == telemetry.M_QUEUE_WAIT_S])
    EngineConfig.cluster_workers = 2
    EngineConfig.cluster_federation_s = 0.1
    out = str(tmp_path)
    with HealthMonitor() as mon, \
            Telemetry(name="fed", out_dir=out, exemplar_k=4) as tel:
        try:
            # both workers booted before the first observation: the
            # merged window must hold both workers' values
            router = cluster_router.maybe_router()
            assert len(router.device_sections()) == 2
            got = ops.frame().withColumnBatch(
                "y", ops.aggregate_breach).collect()
            _wait_for(lambda: mon.count(health.SLO_BREACH) == 1,
                      "the federated breach")
            # the flight recorder writes the bundle after the breach,
            # on its own thread
            _wait_for(lambda: mon.count(health.POSTMORTEM_DUMPED) == 1,
                      "the postmortem bundle")
            assert len(glob.glob(os.path.join(out, "postmortem_*"))) == 1
            _wait_for(lambda: mon.count(health.SLO_RECOVERED) == 1,
                      "the federated recovery")
        finally:
            cluster_router.shutdown()
    assert [r["y"] for r in got] == [2.0 * i for i in range(24)]
    assert mon.count(health.SLO_BREACH) == 1
    (breach,) = mon.events(health.SLO_BREACH)
    assert breach["rule"].startswith(slo.FEDERATED_RULE_PREFIX)
    assert breach["observed"] >= 1.0
    assert len(breach["workers"]) == 2
    assert all(v < 1.0 for v in breach["workers"].values())
    assert all(e["trace_id"] == tel.run_id for e in breach["exemplars"])
    (bundle,) = glob.glob(os.path.join(out, "postmortem_*"))
    assert sorted(os.listdir(bundle)) == [
        "breach.json", "health.json", "snapshots.jsonl", "trace.json"]
    fed = cluster_router.last_cluster_report()["federation"]
    assert fed["workers_known"] == 2 and fed["postmortems"] == [bundle]


# -- the federation fold, no processes ---------------------------------------

def _registry(exemplar_k=0):
    return telemetry.MetricsRegistry(window_s=60.0, window_buckets=12,
                                     exemplar_k=exemplar_k)


def _frame(reg, worker, wid, seq=1, offset_ns=0):
    shim = types.SimpleNamespace(metrics=reg)
    frame = aggregate.build_frame(worker, wid, seq, shim,
                                  clock_offset_ns=offset_ns)
    assert frame is not None
    return frame


def test_fold_sums_counters_and_merges_histogram_buckets(monkeypatch):
    now = 1002.5
    monkeypatch.setattr(telemetry, "_monotonic", lambda: now)
    reg_a, reg_b = _registry(), _registry()
    reg_a.counter(telemetry.M_ENGINE_ROWS_OUT).inc(3)
    reg_b.counter(telemetry.M_ENGINE_ROWS_OUT).inc(5)
    reg_a.gauge(telemetry.M_EXECUTOR_QUEUE_DEPTH).set(2.0)
    reg_b.gauge(telemetry.M_EXECUTOR_QUEUE_DEPTH).set(7.0)
    for v in (0.2, 0.2, 0.4):
        reg_a.histogram(telemetry.M_QUEUE_WAIT_S).observe(v)
    for v in (0.2, 0.8):
        reg_b.histogram(telemetry.M_QUEUE_WAIT_S).observe(v)
    view = aggregate.ClusterMetricsView(cadence_s=0.25)
    view.ingest(_frame(reg_a, "w0", 0), now=now)
    view.ingest(_frame(reg_b, "w1", 1), now=now)
    snap = view.window_snapshot(60.0, now=now)
    assert snap["workers_reporting"] == 2
    assert snap["counters"][telemetry.M_ENGINE_ROWS_OUT]["count"] == 8
    gauge = snap["gauges"][telemetry.M_EXECUTOR_QUEUE_DEPTH]
    assert (gauge["min"], gauge["max"]) == (2.0, 7.0)
    hist = snap["histograms"][telemetry.M_QUEUE_WAIT_S]
    assert hist["count"] == 5 and hist["sum"] == pytest.approx(1.8)
    assert (hist["min"], hist["max"]) == (0.2, 0.8)
    assert view.attribution(telemetry.M_QUEUE_WAIT_S, "count", 60.0,
                            now=now) == {"w0": 3, "w1": 2}


def test_merged_p99_breaches_where_no_single_worker_does(monkeypatch):
    now = 1002.5
    monkeypatch.setattr(telemetry, "_monotonic", lambda: now)
    reg_a, reg_b = _registry(exemplar_k=4), _registry(exemplar_k=4)
    ctx_a = telemetry.SpanContext(trace_id="run-x", span_id=0xA)
    for v in [0.2] * 99 + [1.3]:
        reg_a.histogram(telemetry.M_QUEUE_WAIT_S).observe(v, exemplar=ctx_a)
    for v in [0.2] * 98 + [0.9, 0.9]:
        reg_b.histogram(telemetry.M_QUEUE_WAIT_S).observe(v)
    view = aggregate.ClusterMetricsView(cadence_s=0.25)
    view.ingest(_frame(reg_a, "w-a", 0), now=now)
    view.ingest(_frame(reg_b, "w-b", 1), now=now)
    attr = view.attribution(telemetry.M_QUEUE_WAIT_S, "p99", 30.0, now=now)
    assert all(v is not None and v < 1.0 for v in attr.values())
    merged = view.window_snapshot(30.0, now=now)["histograms"][
        telemetry.M_QUEUE_WAIT_S]
    assert merged["p99"] >= 1.0 and merged["max"] == 1.3
    assert merged["exemplars"][0]["span_id"] == 0xA
    (rule,) = [r for r in slo.federated_default_rules(window_s=30.0)
               if r.metric == telemetry.M_QUEUE_WAIT_S]
    with HealthMonitor() as mon:
        wd = slo.SLOWatchdog([rule], attribution=lambda r: view.attribution(
            r.metric, r.stat, r.window_s, now=now))
        verdicts = wd.evaluate(view, now=now)
    assert verdicts[rule.name]["breached"] is True
    (breach,) = mon.events(health.SLO_BREACH)
    assert breach["workers"] == attr


def test_skewed_worker_epochs_rebase_with_no_double_count_no_gap(
        monkeypatch):
    coord_now = 1002.5
    monkeypatch.setattr(telemetry, "_monotonic",
                        lambda: coord_now + 2 * _SPAN_S)
    reg_a = _registry()
    for v in (0.2, 0.2, 0.2):
        reg_a.histogram(telemetry.M_QUEUE_WAIT_S).observe(v)
    frame_a = _frame(reg_a, "w-ahead", 0, offset_ns=int(-2 * _SPAN_S * 1e9))
    monkeypatch.setattr(telemetry, "_monotonic",
                        lambda: coord_now - 2 * _SPAN_S)
    reg_b = _registry()
    for v in (0.9, 0.9):
        reg_b.histogram(telemetry.M_QUEUE_WAIT_S).observe(v)
    frame_b = _frame(reg_b, "w-behind", 1, offset_ns=int(2 * _SPAN_S * 1e9))
    view = aggregate.ClusterMetricsView(cadence_s=0.25)
    view.ingest(frame_a, now=coord_now)
    view.ingest(frame_b, now=coord_now)
    for window_s in (_SPAN_S, 60.0):
        hist = view.window_snapshot(window_s, now=coord_now)[
            "histograms"][telemetry.M_QUEUE_WAIT_S]
        assert hist["count"] == 5
        assert hist["sum"] == pytest.approx(3 * 0.2 + 2 * 0.9)


def test_stale_and_dead_workers_age_out_but_frames_are_retained():
    view = aggregate.ClusterMetricsView(cadence_s=0.1)
    reg_a, reg_b = _registry(), _registry()
    reg_a.histogram(telemetry.M_QUEUE_WAIT_S).observe(0.2)
    reg_b.histogram(telemetry.M_QUEUE_WAIT_S).observe(0.4)
    view.ingest(_frame(reg_a, "w0", 0), now=100.0)
    view.ingest(_frame(reg_b, "w1", 1), now=100.0)
    assert view.fresh_workers(now=100.0) == ["w0", "w1"]
    assert view.workers_reporting(now=100.31) == 0
    view.ingest(_frame(reg_a, "w0", 0, seq=2), now=200.0)
    view.ingest(_frame(reg_b, "w1", 1, seq=2), now=200.0)
    view.mark_dead("w1")
    snap = view.window_snapshot(60.0, now=200.0)
    assert snap["workers_reporting"] == 1
    assert snap["histograms"][telemetry.M_QUEUE_WAIT_S]["count"] == 1
    frames = view.last_frames()
    assert frames["w1"]["alive"] is False and frames["w1"]["frame"]["seq"] == 2
    assert view.status(now=200.0)["frames_ingested"] == 4
    assert "sparkdl_cluster:workers_reporting 1" in view.prometheus_text(
        now=200.0)


def test_merge_sums_device_counts_and_keeps_off_path_shape():
    snaps = [{"worker": f"w{i}", "tasks": 1, "rows": 4, "exec_s": 0.1,
              "metrics": {}, "health": {"counters": {}},
              "device": {"launches": {"sep2d": 34 * (i + 1)},
                         "launches_by_body": {"sep2d": {"wgmma": 34 * (i + 1)}},
                         "forwards": i + 1, "captures": 1}}
             for i in range(2)]
    rep = aggregate.merge_snapshots(snaps)
    assert rep["device"] == {"launches": {"sep2d": 102},
                             "launches_by_body": {"sep2d": {"wgmma": 102}},
                             "forwards": 3, "captures": 2}
    for s in snaps:
        del s["device"]
    assert "device" not in aggregate.merge_snapshots(snaps)


_NATIVE_RUN = """
import json, sys

if __name__ == "__main__":
    import numpy as np
    from PIL import Image

    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.cluster import router
    from sparkdl_tpu_torch.native import loader

    d = sys.argv[1]
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
                        ).save(f"{d}/img{i}.png")
    s.EngineConfig.device = "cpu"
    s.EngineConfig.max_workers = 3
    s.EngineConfig.cluster_workers = 2
    got = s.readImages(d, numPartition=3).collect()
    router.shutdown()
    rep = router.last_cluster_report()
    s.EngineConfig.cluster_workers = 0
    want = s.readImages(d, numPartition=3).collect()
    print(json.dumps({
        "coordinator": loader.status(),
        "workers": {w: [snap["tasks"], snap["device"]["native_loader"]]
                    for w, snap in rep["workers"].items()},
        "equal": [g["image"]["data"] == w["image"]["data"]
                  for g, w in zip(got, want)]}))
"""


def test_workers_decode_with_the_native_loader_on_a_fresh_build(tmp_path):
    """In a checkout where nothing is built, the router builds the native
    image loader before it spawns, so its workers (which only load) decode
    with it, as the in-process run does."""
    import shutil
    import subprocess
    import sys

    if shutil.which("g++") is None or not all(
            os.path.exists(f"/usr/include/{h}")
            for h in ("jpeglib.h", "png.h")):
        pytest.skip("g++ or the libjpeg/libpng headers are missing here")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkout = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "sparkdl_tpu_torch"),
                    checkout / "sparkdl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "run.py").write_text(_NATIVE_RUN)
    (tmp_path / "images").mkdir()
    env = dict(os.environ, PYTHONPATH=str(checkout))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "run.py"), str(tmp_path / "images")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert list((checkout / "build" / "sparkdl_tpu_torch").glob(
        "libimage_loader_*.so"))
    assert got["coordinator"] == "loaded"
    ran = [status for tasks, status in got["workers"].values() if tasks]
    assert ran and all(status == "loaded" for status in ran), got
    assert got["equal"] == [True] * 6
