"""The port's online serving plane against the JAX package's, on the CPU.

Parity cases build the object in both packages from the same seeded
numpy inputs: both ResidencyManagers take one acquire sequence (``lru``
and ``weighted``) and must report the same ``status()`` after each step;
both ModelRegistries take one request sequence and must pick the same
shadow set; both ModelServers serve TestNet (weights carried across by
``from_flax_variables``) within the float32 slice tolerance
``1e-3·max|ref|``, shed alike under one windowed queue-wait, and
validate the serving knobs alike. The port alone: hot-swap under 4
threads with no request dropped or served twice, ``retire_model``
skipping a busy coalescing state, the warm-up capturing every rung so
the first request compiles nothing, eviction releasing every variant's
programs, and a transformer and an image UDF over a served name
following a cutover. Every join and wait is bounded; the one sleep is
a 5 ms poll.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.core import executor as jax_executor
from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import telemetry as jax_telemetry
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu import serving as jax_serving
from sparkdl_tpu_torch import serving
from sparkdl_tpu_torch.core import executor, health, telemetry
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.udf import registry as torch_udf
from tests.torch_port_helpers import headless, max_abs, random_variables

F32_REL = 1e-3
JOIN_S = 20.0


@pytest.fixture(autouse=True)
def _fresh():
    saved, jsaved = EngineConfig.snapshot(), JaxEngineConfig.snapshot()
    kinds = {m: dict(m.CANONICAL_METRIC_KINDS)
             for m in (telemetry, jax_telemetry)}
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.bucket_ladder = "pow2"
    executor.reset()
    jax_executor.reset()
    yield
    executor.reset()
    jax_executor.reset()
    EngineConfig.restore(saved)
    JaxEngineConfig.restore(jsaved)
    for m, k in kinds.items():  # names declared here leave the catalogs
        m.CANONICAL_METRIC_KINDS.clear()
        m.CANONICAL_METRIC_KINDS.update(k)
        m.CANONICAL_METRIC_NAMES = frozenset(k)


# ---------------------------------------------------------------------------
# Residency: one acquire sequence, both managers
# ---------------------------------------------------------------------------

_UNIT = 64  # float32 elements of one size unit


def _pair_loaders(name, units):
    """A loader of each package returning a model of ``units`` size
    units (the same bytes in both)."""
    w = np.random.default_rng(len(name) * 7 + units).normal(
        size=(units, _UNIT)).astype(np.float32)

    def ours():
        return ModelFunction(lambda vs, x: x @ vs.T, torch.from_numpy(w),
                             TensorSpec((None, _UNIT)), name=name)

    def ref():
        return JaxModelFunction(lambda vs, x: x @ vs.T, jnp.asarray(w),
                                JaxTensorSpec((None, _UNIT)), name=name)

    return ours, ref


# (name, size units, pinned)
_RESIDENTS = [("a", 1, False), ("b", 2, False), ("c", 3, False),
              ("d", 1, True), ("e", 2, False)]
_ACQUIRES = ["a", "b", "a", "c", "d", "b", "e", "a", "c", "e", "b", "d",
             "a", "evict:b", "c", "evict:d", "b", "e", "a", "c"]


@pytest.mark.parametrize("policy", ["lru", "weighted"])
def test_residency_status_matches_after_every_step(policy):
    budget = 5 * _UNIT * 4
    ours = serving.ResidencyManager(budget, policy=policy)
    ref = jax_serving.ResidencyManager(budget, policy=policy)
    for name, units, pinned in _RESIDENTS:
        load, jload = _pair_loaders(name, units)
        ours.register(name, "v1", load, pinned=pinned)
        ref.register(name, "v1", jload, pinned=pinned)
    for step in _ACQUIRES:
        results = []
        for res in (ours, ref):
            try:
                if step.startswith("evict:"):
                    results.append(res.evict(step[6:], "v1"))
                else:
                    results.append(res.acquire(step, "v1").name)
            except Exception as e:  # noqa: BLE001 - compared below
                results.append((type(e).__name__, str(e)))
        assert results[0] == results[1], step
        assert ours.status() == ref.status(), step
    status = ours.status()
    assert status["evictions"] > 3 and status["cold_starts"] > 5
    assert status["resident_bytes"] <= budget


def test_residency_exhausted_and_failed_loader_match():
    for res_mod in (serving, jax_serving):
        res = res_mod.ResidencyManager(2 * _UNIT * 4)
        pkg = 0 if res_mod is serving else 1
        big = _pair_loaders("big", 3)[pkg]
        res.register("big", "v1", big, pinned=True)
        with pytest.raises(res_mod.ResidencyExhausted, match="pinned"):
            res.acquire("big", "v1")

        def broken():
            raise OSError("weights missing")

        res.register("broken", "v1", broken)
        with pytest.raises(OSError):
            res.acquire("broken", "v1")
        assert res.status()["residents"][1]["resident"] is False
        with pytest.raises(KeyError):
            res.acquire("nope", "v1")
        with pytest.raises(ValueError):
            res_mod.ResidencyManager(0)
        with pytest.raises(ValueError):
            res_mod.ResidencyManager(8, policy="fifo")


# ---------------------------------------------------------------------------
# Registry: one request sequence, both registries
# ---------------------------------------------------------------------------

def _resolve_log(reg_mod, ops):
    reg = reg_mod.ModelRegistry()
    for v in ("v1", "v2", "v3"):
        reg.deploy("m", v, loader=lambda: None)
    log = []
    for op in ops:
        kind = op[0]
        if kind == "resolve":
            for _ in range(op[1]):
                active, shadow = reg.resolve("m")
                log.append((active.version,
                            None if shadow is None else shadow.version))
        elif kind == "shadow":
            reg.shadow("m", op[1], fraction=op[2])
        elif kind == "cutover":
            log.append(("cutover", reg.cutover("m", op[1])))
        elif kind == "rollback":
            log.append(("rollback", reg.rollback("m")))
        log.append(("status", reg.status("m")))
    return log


_REGISTRY_OPS = [
    ("resolve", 3), ("shadow", "v2", 0.3), ("resolve", 20),
    ("shadow", "v3", 0.5), ("resolve", 9), ("cutover", "v3"),
    ("resolve", 4), ("shadow", "v2", 1.0), ("resolve", 3),
    ("shadow", "v1", 0.25), ("resolve", 11), ("rollback",),
    ("resolve", 5), ("shadow", None, 0.0), ("resolve", 2),
    ("cutover", "v2"), ("shadow", "v3", 0.7), ("resolve", 13),
]


def test_registry_shadow_set_and_status_match():
    ours = _resolve_log(serving.registry, _REGISTRY_OPS)
    ref = _resolve_log(jax_serving.registry, _REGISTRY_OPS)
    assert ours == ref
    shadowed = [e for e in ours if len(e) == 2 and e[1] is not None
                and e[0] not in ("cutover", "rollback", "status")]
    assert 10 < len(shadowed) < 60


def test_registry_refusals_match():
    for reg_mod in (serving.registry, jax_serving.registry):
        reg = reg_mod.ModelRegistry()
        reg.deploy("m", "v1", loader=lambda: None, latency_target_ms=40)
        with pytest.raises(ValueError, match="immutable"):
            reg.deploy("m", "v1", loader=lambda: None)
        with pytest.raises(ValueError, match="exactly one"):
            reg.deploy("m", "v2")
        with pytest.raises(ValueError, match="latency_target_ms"):
            reg.deploy("m", "v3", loader=lambda: None, latency_target_ms=0)
        with pytest.raises(ValueError, match="onto itself"):
            reg.shadow("m", "v1")
        with pytest.raises(ValueError, match="fraction"):
            reg.shadow("m", "v1", fraction=1.5)
        with pytest.raises(ValueError, match="no previous"):
            reg.rollback("m")
        with pytest.raises(KeyError):
            reg.resolve("other")
        assert reg.targets() == {"m": 0.04}


# ---------------------------------------------------------------------------
# ModelServer on TestNet in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def testnet_weights():
    jm = jax_testnet.TestNet(include_top=True)
    return (headless(random_variables(jm, (1, 32, 32, 3), seed=171)),
            headless(random_variables(jm, (1, 32, 32, 3), seed=172)))


def _servers(testnet_weights, **kw):
    w1, w2 = testnet_weights
    reg, jreg = serving.ModelRegistry(), jax_serving.ModelRegistry()
    for version, w in (("v1", w1), ("v2", w2)):
        reg.deploy("tn", version, loader=lambda w=w:
                   registry.build_featurizer("TestNet", weights=w),
                   batch_size=4, **kw)
        jreg.deploy("tn", version, loader=lambda w=w:
                    jax_registry.build_featurizer("TestNet", weights=w),
                    batch_size=4, **kw)
    return (serving.ModelServer(reg), jax_serving.ModelServer(jreg),
            reg, jreg)


def test_predict_matches_reference_server(testnet_weights):
    """A single row (its batch dim squeezed back) and a small batch, the
    active version answering and a shadowed request compared on the bulk
    lane, as the reference's server does."""
    srv, jsrv, reg, jreg = _servers(testnet_weights)
    rng = np.random.default_rng(173)
    row = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    for rows in (row, batch):
        got, want = srv.predict("tn", rows), jsrv.predict("tn", rows)
        assert got.version == want.version == "v1"
        assert got.output.shape == np.asarray(want.output).shape
        assert max_abs(got.output, want.output) <= \
            F32_REL * np.abs(want.output).max()
    reg.shadow("tn", "v2", fraction=1.0)
    jreg.shadow("tn", "v2", fraction=1.0)
    with health.HealthMonitor() as mon, \
            jax_health.HealthMonitor() as jmon:
        got, want = srv.predict("tn", batch), jsrv.predict("tn", batch)
    assert got.shadowed and want.shadowed and got.version == "v1"
    (ev,), (jev,) = (mon.events(health.SERVING_SHADOW_COMPARED),
                     jmon.events(jax_health.SERVING_SHADOW_COMPARED))
    assert ev["shadow_version"] == jev["shadow_version"] == "v2"
    assert abs(ev["divergence"] - jev["divergence"]) <= \
        F32_REL * np.abs(want.output).max()
    assert srv.status() == jsrv.status()


def test_admission_sheds_alike_on_windowed_queue_wait(testnet_weights):
    """With the windowed queue-wait p99 over the target's budget, both
    servers shed before staging (one serving_shed event each, the same
    p99 and budget); ``block`` admission serves."""
    w1, _ = testnet_weights
    row = np.zeros((32, 32, 3), np.uint8)
    events = []
    for mod, smod, hmod, reg_mod in (
            (telemetry, serving, health, registry),
            (jax_telemetry, jax_serving, jax_health, jax_registry)):
        reg = smod.ModelRegistry()
        reg.deploy("tn", "v1", loader=lambda: reg_mod.build_featurizer(
            "TestNet", weights=w1), latency_target_ms=20.0)
        shed, block = (smod.ModelServer(reg, slo_window_s=5.0),
                       smod.ModelServer(reg, admission="block"))
        with hmod.HealthMonitor() as mon, \
                mod.Telemetry("shed", window_s=10.0):
            mod.observe(mod.M_QUEUE_WAIT_S, 0.5)
            with pytest.raises(smod.ServingOverloaded, match="queue budget"):
                shed.predict("tn", row)
            assert block.predict("tn", row).output.shape == (16,)
        (ev,) = mon.events(hmod.SERVING_SHED)
        events.append({k: ev[k] for k in ("model", "version",
                                          "queue_wait_p99_s", "budget_s",
                                          "tenant")})
    assert events[0] == events[1]


def test_serving_knobs_validate_alike():
    for knob, bad in (("serving_warmup", 1), ("serving_cluster", "yes"),
                      ("serving_worker_residency_bytes", 0),
                      ("serving_worker_residency_bytes", -4096),
                      ("serving_failover_max", -1)):
        msgs = []
        for cfg in (EngineConfig, JaxEngineConfig):
            saved = cfg.snapshot()
            setattr(cfg, knob, bad)
            try:
                with pytest.raises(ValueError) as err:
                    cfg.validate()
                msgs.append(str(err.value))
            finally:
                cfg.restore(saved)
        assert msgs[0] == msgs[1], knob
    for knob in ("serving_warmup", "serving_cluster",
                 "serving_worker_residency_bytes", "serving_failover_max"):
        assert EngineConfig.snapshot()[knob] == \
            JaxEngineConfig.snapshot()[knob]


def test_serving_names_resolve_at_the_top_level():
    assert serving.ModelServer is sparkdl_tpu_torch.ModelServer
    assert sparkdl_tpu_torch.SLORule is sparkdl_tpu_torch.slo.SLORule


# ---------------------------------------------------------------------------
# The port alone: hot swap, retirement, warm-up, eviction, served names
# ---------------------------------------------------------------------------

_ELEMENT = (6,)


def _toy(seed, name="toy", gate=None):
    """Row-wise ``tanh(x @ w)``; ``gate`` (an Event) blocks each forward
    until set."""
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(_ELEMENT[0], 3)).astype(np.float32))

    def apply_fn(vs, x):
        if gate is not None:
            gate.wait(JOIN_S)
        return torch.tanh(x @ vs)

    return ModelFunction(apply_fn, w, TensorSpec((None,) + _ELEMENT),
                         name=name)


def test_hot_swap_under_four_threads_drops_and_doubles_nothing():
    reg = serving.ModelRegistry()
    models = {"v1": _toy(1), "v2": _toy(2)}
    for v, m in models.items():
        reg.deploy("swap", v, model=m, batch_size=8)
    srv = serving.ModelServer(reg)
    rows = np.random.default_rng(3).normal(
        size=(4, 40) + _ELEMENT).astype(np.float32)
    results = [[None] * 40 for _ in range(4)]
    done = threading.Semaphore(0)

    def client(t):
        for i in range(40):
            results[t][i] = srv.predict("swap", rows[t, i])
            done.release()

    with health.HealthMonitor() as mon:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for _ in range(50):
            assert done.acquire(timeout=JOIN_S)
        assert srv.cutover("swap", "v2") == "v1"
        for _ in range(60):
            assert done.acquire(timeout=JOIN_S)
        assert srv.rollback("swap") == "v2"
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    assert mon.count(health.SERVING_CUTOVER) == 2
    versions = {"v1": 0, "v2": 0}
    for t in range(4):
        for i, res in enumerate(results[t]):
            assert res is not None and res.output.shape == (3,)
            versions[res.version] += 1
            want = torch.tanh(torch.from_numpy(rows[t, i][None])
                              @ models[res.version].variables)[0].numpy()
            np.testing.assert_allclose(res.output, want, rtol=1e-6,
                                       atol=1e-6)
    assert sum(versions.values()) == 160
    assert versions["v1"] > 0 and versions["v2"] > 0
    assert srv.status()["inflight"] == 0


def test_retire_model_skips_a_busy_state_and_wakes_an_idle_one():
    gate = threading.Event()
    mf = _toy(4, name="retire", gate=gate)
    rows = np.ones((2,) + _ELEMENT, np.float32)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        executor.execute(mf, rows, batch_size=8))) for _ in range(2)]
    for t in threads:
        t.start()
    svc = executor.service()
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline:
        states = list(svc._states.values())
        if states and (states[0].pending or states[0].thread is not None):
            break
        time.sleep(0.005)
    (state,) = svc._states.values()
    assert svc.retire_model(mf) == 0  # in flight and queued: skipped
    assert not state.retired
    gate.set()
    for t in threads:
        t.join(JOIN_S)
    assert len(out) == 2
    coalescer = state.thread
    assert coalescer is not None and coalescer.is_alive()  # parked
    assert svc.retire_model(mf, variants=mf.device_variants()) == 1
    coalescer.join(JOIN_S)
    assert not coalescer.is_alive() and state.retired
    assert svc._states == {}
    # a later request builds a fresh state and is served
    assert executor.execute(mf, rows, batch_size=8).shape == (2, 3)


def _image_model(seed):
    return registry.build_featurizer(
        "TestNet", weights=headless(random_variables(
            jax_testnet.TestNet(include_top=True), (1, 32, 32, 3),
            seed=seed)))


def test_warmup_captures_every_rung_so_the_first_request_compiles_nothing():
    EngineConfig.serving_warmup = True
    reg = serving.ModelRegistry()
    with health.HealthMonitor() as mon, telemetry.Telemetry("warm") as tel:
        reg.deploy("warm", "v1", loader=lambda: _image_model(181),
                   batch_size=16)
        compiles = len(tel.tracer.spans(telemetry.SPAN_COMPILE))
        srv = serving.ModelServer(reg)
        row = np.full((32, 32, 3), 7, np.uint8)
        assert srv.predict("warm", row).output.shape == (16,)
        assert srv.predict("warm", row[None].astype(np.float32)
                           ).output.shape == (1, 16)
        assert len(tel.tracer.spans(telemetry.SPAN_COMPILE)) == compiles
    (ev,) = mon.events(health.WARMUP_COMPLETED)
    assert ev["rungs"] == 2 and ev["model"] == "warm"
    assert compiles == 4  # rungs 8 and 16, in float32 and uint8
    (span,) = tel.tracer.spans(telemetry.SPAN_SERVING_WARMUP)
    assert span["attributes"]["rungs"] == "(8, 16)"
    assert len(tel.tracer.spans(telemetry.SPAN_MODEL_LOAD)) == 1


def test_eviction_releases_every_variant_and_reloads_alike():
    """Every memoized variant's programs go with an eviction, the
    executor state that pinned the model retires, and the reload (a
    cold start under a model_load span) answers the same bits."""
    one = _image_model(190).weight_bytes()
    res = serving.ResidencyManager(one + one // 2)  # one model at a time
    reg = serving.ModelRegistry(residency=res)
    for name, seed in (("first", 191), ("second", 192)):
        reg.deploy(name, "v1", loader=lambda s=seed: _image_model(s),
                   batch_size=4)
        res.pin(name, "v1", pinned=False)
    srv = serving.ModelServer(reg)
    row = np.random.default_rng(193).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    first = res.acquire("first", "v1")
    variants = [first.flattened(), first.resized((40, 40)),
                first.with_dtype("bfloat16")]
    for v in variants:
        v.jitted("cpu")
    before = srv.predict("first", row).output
    assert set(map(id, first.device_variants())) >= set(map(id, variants))
    with health.HealthMonitor() as mon, telemetry.Telemetry("ev") as tel:
        srv.predict("second", row)  # over budget: evicts "first"
        assert not res.is_resident("first", "v1")
        assert first._programs == {} and first._precision_cache == {}
        assert first._flat_cache is None and first._resize_cache == {}
        assert all(v._programs == {} for v in variants)
        assert all(s.model is not first
                   for s in executor.service()._states.values())
        after = srv.predict("first", row).output
    np.testing.assert_array_equal(before, after)
    assert mon.count(health.SERVING_EVICTED) == 2
    assert mon.count(health.SERVING_COLD_START) == 2
    assert len(tel.tracer.spans(telemetry.SPAN_MODEL_LOAD)) == 2
    assert tel.metrics.snapshot()["counters"][
        telemetry.M_SERVING_EVICTIONS] == 2


def test_precision_variant_asked_for_its_own_precision_is_itself():
    mf = _image_model(194)
    bf16 = mf.with_dtype("bfloat16")
    assert bf16.compute_dtype == "bfloat16"
    assert bf16.with_dtype("bfloat16") is bf16
    wrapped = bf16.resized((40, 40))
    assert wrapped.with_dtype("bfloat16") is wrapped
    assert mf.with_dtype("bfloat16") is bf16 and mf.compute_dtype is None
    assert bf16.with_dtype("float32") is bf16


def test_transformer_and_udf_over_a_served_name_follow_a_cutover():
    from sparkdl_tpu_torch.engine import dataframe as torch_dataframe

    reg = serving.default_registry()
    name = "served_tn_%d" % time.monotonic_ns()
    models = {"v1": _image_model(201), "v2": _image_model(202)}
    for v, m in models.items():
        reg.deploy(name, v, model=m)
    rng = np.random.default_rng(203)
    arrays = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
              for _ in range(3)]
    df = sparkdl_tpu_torch.DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(arrays, list("abc"))})

    def features(model):
        rows = TorchImageTransformer(inputCol="image", outputCol="f",
                                     modelFunction=model,
                                     outputMode="vector").transform(
            df).collect()
        return np.stack([np.asarray(r["f"], np.float32) for r in rows])

    want = {v: features(m) for v, m in models.items()}
    served = TorchImageTransformer(inputCol="image", outputCol="f",
                                   modelFunction=name, outputMode="vector")
    udf_name = name + "_udf"
    sparkdl_tpu_torch.registerImageUDF(udf_name, name)
    df.createOrReplaceTempView(name)
    try:
        for step in ("v1", "cutover", "rollback"):
            if step == "cutover":
                reg.cutover(name, "v2")
            elif step == "rollback":
                reg.rollback(name)
            version = reg.active_version(name)
            got = np.stack([np.asarray(r["f"], np.float32)
                            for r in served.transform(df).collect()])
            np.testing.assert_array_equal(got, want[version])
            rows = sparkdl_tpu_torch.sql(
                f"SELECT {udf_name}(image) AS f FROM {name}").collect()
            np.testing.assert_array_equal(
                np.stack([np.asarray(r["f"], np.float32) for r in rows]),
                want[version])
    finally:
        torch_dataframe._temp_views.pop(name, None)
        torch_udf.udf_registry.unregister(udf_name)
    assert served.getModelFunction() is models["v1"]
