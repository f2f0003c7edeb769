"""The featurize path's host side in the port against the JAX package's,
on the same seeded inputs, at small sizes on the CPU.
"""

import numpy as np
import pytest
import torch

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.core import batching as jax_batching
from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import pipeline as jax_pipeline
from sparkdl_tpu.core import profiling as jax_profiling
from sparkdl_tpu.core import telemetry as jax_telemetry
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models.layers import SeparableConvBN as JaxSeparableConvBN
from sparkdl_tpu_torch.core import (
    batching, health, pipeline, profiling, telemetry,
)
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.layers import SeparableConvBN
from tests.torch_port_helpers import (
    column, frames, max_abs, random_variables,
)


#: (name, the same function in each package's array library)
EMPTY_FNS = [
    ("flatten", lambda x: x.reshape(x.shape[0], -1)),
    ("scale", lambda x: x * 0.5),
    ("spatial_mean", lambda x: x.mean(axis=(1, 2))),
]


@pytest.mark.parametrize("in_dtype", [np.float64, np.uint8])
@pytest.mark.parametrize("name,fn", EMPTY_FNS, ids=[n for n, _ in EMPTY_FNS])
def test_empty_batch_matches_reference(name, fn, in_dtype):
    """Zero rows give a zero-row array of the output's element shape and
    dtype, as the JAX package's ``apply_batch`` does."""
    x = np.zeros((0, 4, 4, 3), in_dtype)
    ref = JaxModelFunction.fromFunction(
        lambda vs, a: fn(a), None, JaxTensorSpec((None, 4, 4, 3))
    ).apply_batch(x, batch_size=8)
    mf = ModelFunction.fromFunction(lambda vs, a: fn(a), None,
                                    TensorSpec((None, 4, 4, 3)))
    ours = mf.apply_batch(x, batch_size=8, device="cpu")
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, \
        (ours.shape, ours.dtype, ref.shape, ref.dtype)
    assert mf.apply_batch(x, batch_size=8, device="cpu").shape == ref.shape


def test_empty_batch_of_a_registry_model():
    """A named model's empty batch has its feature width, from a pass on
    meta tensors (no weights touched, nothing computed)."""
    mf = registry.build_featurizer("Xception", weights="random", seed=0)
    out = mf.flattened().apply_batch(np.zeros((0, 75, 75, 3), np.uint8),
                                     batch_size=4, device="cpu")
    assert out.shape == (0, 2048) and out.dtype == np.float32


@pytest.mark.parametrize("mode", ["caffe", "torch", "tf"])
def test_preprocess_modes_match_reference(mode):
    """The registry's preprocess modes, with their constants made once
    per (dtype, device), give the JAX package's values."""
    x = np.random.default_rng(5).uniform(0, 255, (2, 3, 4, 3)) \
        .astype(np.float32)
    ours_fn = registry.PREPROCESS_MODES[mode]
    ref_fn = getattr(jax_registry, f"preprocess_{mode}_mode")
    ours = ours_fn(torch.from_numpy(x))
    again = ours_fn(torch.from_numpy(x))
    ref = np.asarray(ref_fn(x))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(ours, again)
    if mode != "tf":
        consts = [v for k, v in registry._CONSTANTS.items()
                  if k[1] == torch.float32 and k[2] == torch.device("cpu")]
        assert consts and all(not c.is_inference() for c in consts)
        n = len(registry._CONSTANTS)
        ours_fn(torch.from_numpy(x))
        assert len(registry._CONSTANTS) == n


# ---------------------------------------------------------------------------
# The bucket planner, iter_batches and run_batched
# ---------------------------------------------------------------------------


def _sizes(seed: int, n: int, batch_size: int):
    """A skewed stream of chunk sizes: mostly small tails, some full."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([3, 5, 5, 6, 11, batch_size], size=n)
    return [int(v) for v in sizes]


@pytest.mark.parametrize("batch_size", [16, 40])
def test_bucket_planner_matches_reference(batch_size):
    """The same stream of sizes gives the same ladder after every
    observation, and the same bucket for every n ≤ batch_size."""
    ours = batching.BucketPlanner(batch_size, name="m", update_every=8)
    ref = jax_batching.BucketPlanner(batch_size, name="m", update_every=8)
    assert ours.ladder() == ref.ladder()
    ladders = {ours.ladder()}
    for n in _sizes(batch_size, 120, batch_size):
        assert ours.plan(n) == ref.plan(n)
        assert ours.ladder() == ref.ladder()
        ladders.add(ours.ladder())
        assert [ours.bucket_for(k) for k in range(1, batch_size + 1)] == \
            [ref.bucket_for(k) for k in range(1, batch_size + 1)]
    assert len(ladders) > 1  # the stream retuned the ladder
    assert ours.bucket_for(3, cap=8) == ref.bucket_for(3, cap=8)
    assert batching._pow2_ladder(batch_size, 8) == \
        jax_batching._pow2_ladder(batch_size, 1, 8)


def test_ladder_store_round_trips(tmp_path, monkeypatch):
    """A retuned ladder persists beside the verdict store, a new planner
    of the same (model, batch size) starts from it, and the file is the
    reference's format: each package reads the other's ladder."""
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE_DIR", str(tmp_path))
    batching.reset_planners()
    try:
        planner = batching.planner_for("store", 16)
        planner.update_every = 8
        for n in _sizes(16, 16, 16):
            planner.plan(n)
        tuned = planner.ladder()
        assert tuned != batching._pow2_ladder(16, 8)
        assert batching.ladder_store_path() == \
            str(tmp_path / "sparkdl_bucket_ladders.json")
        assert batching._load_ladder("store", 16) == tuned
        assert jax_batching._load_ladder("store", 16, 1) == tuned
        batching.reset_planners()
        assert batching.planner_for("store", 16).ladder() == tuned
        assert batching.planner_for("other", 16).ladder() == \
            batching._pow2_ladder(16, 8)
    finally:
        batching.reset_planners()


@pytest.mark.parametrize("planned", [False, True])
def test_iter_batches_matches_reference(planned):
    arr = np.random.default_rng(7).normal(size=(37, 3, 2)).astype(np.float32)
    ours_p = batching.BucketPlanner(16, name="m", update_every=2) \
        if planned else None
    ref_p = jax_batching.BucketPlanner(16, name="m", update_every=2) \
        if planned else None
    ours = list(batching.iter_batches(arr, 16, planner=ours_p))
    ref = list(jax_batching.iter_batches(arr, 16, planner=ref_p))
    assert [n for _, n in ours] == [n for _, n in ref] == [16, 16, 5]
    for (a, _), (b, _) in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _scale_models(spec=(None, 4, 5, 3)):
    fn = lambda vs, x: x * 0.5 + 1.0  # noqa: E731
    return (ModelFunction(fn, None, TensorSpec(spec), name="scale"),
            JaxModelFunction.fromFunction(fn, None, JaxTensorSpec(spec),
                                          name="scale"))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("planned", [False, True])
def test_run_batched_matches_reference(prefetch, planned):
    """21 rows at batch 8: chunks of 8, 8 and a tail of 5 padded to 8,
    staged ahead on the thread at prefetch=2; the outputs equal the JAX
    package's exactly."""
    x = np.random.default_rng(8).integers(0, 256, (21, 4, 5, 3), np.uint8)
    ours, ref = _scale_models()
    kw = {}
    if planned:
        kw = dict(planner=batching.BucketPlanner(8, name="scale"))
    out = ours.apply_batch(x, batch_size=8, device="cpu", prefetch=prefetch,
                           **kw)
    if planned:
        kw = dict(planner=jax_batching.BucketPlanner(8, name="scale"))
    expect = ref.apply_batch(x, batch_size=8, prefetch=prefetch, **kw)
    assert out.dtype == expect.dtype and out.shape == (21, 4, 5, 3)
    np.testing.assert_array_equal(out, np.asarray(expect))


# ---------------------------------------------------------------------------
# The staging pipeline
# ---------------------------------------------------------------------------


def _drain(pkg_pipeline, depth, source, stage_fn=None):
    with pkg_pipeline.DevicePrefetcher(source, stage_fn=stage_fn,
                                       depth=depth) as staged:
        out = list(staged)
    return out, staged


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_prefetcher_matches_reference(depth):
    """The same order and the same staged/consumed counts for a scripted
    source; depth 0 stages inline and starts no thread."""
    items = list(range(9))
    ours, ours_pf = _drain(pipeline, depth, iter(items), lambda v: v * 3)
    ref, ref_pf = _drain(jax_pipeline, depth, iter(items), lambda v: v * 3)
    assert ours == ref == [v * 3 for v in items]
    for key in ("staged", "consumed"):
        assert ours_pf.stats.as_dict()[key] == ref_pf.stats.as_dict()[key]
    assert set(ours_pf.stats.as_dict()) == set(ref_pf.stats.as_dict())
    assert ours_pf._thread is None
    if depth == 0:
        assert ours_pf.stats.stalls == len(items)


def _failing_source():
    yield from range(3)
    raise KeyError("bad row")


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_delivers_errors_in_order(depth):
    """The staging thread's error reaches the consumer at its next
    ``__next__``, after every item staged before it, with the thread
    joined."""
    for pkg in (pipeline, jax_pipeline):
        pf = pkg.DevicePrefetcher(_failing_source(), depth=depth)
        got = [next(pf) for _ in range(3)]
        assert got == [0, 1, 2]
        with pytest.raises(KeyError, match="bad row"):
            next(pf)
        assert pf._thread is None
        with pytest.raises(StopIteration):
            next(pf)


def test_prefetcher_close_joins_the_thread():
    """close() mid-stream wakes a producer blocked on the full queue and
    joins it; closing twice is harmless."""
    def endless():
        n = 0
        while True:
            yield n
            n += 1

    pf = pipeline.DevicePrefetcher(endless(), depth=2)
    assert next(pf) == 0
    thread = pf._thread
    pf.close()
    thread.join(timeout=5)
    assert not thread.is_alive() and pf._thread is None
    pf.close()
    with pytest.raises(StopIteration):
        next(pf)


# ---------------------------------------------------------------------------
# Health, phase timers and telemetry
# ---------------------------------------------------------------------------


def _health_events(pkg_health):
    pkg_health.record(pkg_health.DECODE_DEGRADED, n=2, stage="structs")
    pkg_health.record(pkg_health.DECODE_DEGRADED, stage="bytes")
    pkg_health.record(pkg_health.PREFETCH_REPORT, name="s", staged=3)
    pkg_health.record("custom_event", k=1)


def test_health_monitor_matches_reference():
    reports = []
    for pkg_health in (health, jax_health):
        with pkg_health.HealthMonitor("h", max_events=3) as mon:
            assert pkg_health.active_monitor() is mon
            _health_events(pkg_health)
        assert pkg_health.active_monitor() is None
        reports.append((mon.report(), mon.counters(), mon.events()))
    (ours, ours_c, ours_e), (ref, ref_c, ref_e) = reports
    assert ours == ref and ours_c == ref_c and ours_e == ref_e
    assert ours["counters"] == {"custom_event": 1, "decode_degraded": 3,
                                "prefetch_report": 1}
    assert ours["events_dropped"] == 1
    names = {k for k in vars(jax_health) if k.isupper()}
    assert {k: getattr(health, k) for k in names} == \
        {k: getattr(jax_health, k) for k in names}


def test_phase_timers_match_reference():
    calls = [("sparkdl.decode", 0.5, 1), (profiling.STAGE_BATCH, 0.25, 2),
             (profiling.HOST_WAIT, 0.125, 1), ("sparkdl.device_apply", 2.0, 1),
             ("sparkdl.decode", 0.5, 3)]
    stats = []
    for pkg in (profiling, jax_profiling):
        pkg.reset_phase_stats()
        try:
            for name, seconds, count in calls:
                pkg.add_phase_time(name, seconds, count)
            stats.append((pkg.phase_stats(), pkg.overlap_stats()))
        finally:
            pkg.reset_phase_stats()
    assert stats[0] == stats[1]
    assert stats[0][1]["overlap_ratio"] == 1.0 - 0.125 / 1.25
    for name in ("HOST_WAIT", "STAGE_BATCH", "DEVICE_SYNC",
                 "HOST_ETL_PHASES", "PROFILE_DIR_ENV"):
        assert getattr(profiling, name) == getattr(jax_profiling, name)


def test_telemetry_constants_match_reference():
    names = [k for k in vars(telemetry)
             if k.startswith(("SPAN_", "M_")) or k in (
                 "HEALTH_METRIC_PREFIX", "TELEMETRY_DIR_ENV",
                 "DEFAULT_TIME_BOUNDS", "POW2_BOUNDS")]
    assert len(names) >= 18
    for name in names:
        assert getattr(telemetry, name) == getattr(jax_telemetry, name), name
    assert telemetry.CANONICAL_SPAN_NAMES <= jax_telemetry.CANONICAL_SPAN_NAMES
    for name, kind in telemetry.CANONICAL_METRIC_KINDS.items():
        assert jax_telemetry.CANONICAL_METRIC_KINDS[name] == kind


def _recorded(pkg_telemetry, pkg_health, run):
    with pkg_health.HealthMonitor("h"), pkg_telemetry.Telemetry("t") as tel:
        run()
        pkg_health.record(pkg_health.DECODE_DEGRADED, stage="bytes")
    report = tel.report()
    metrics = report["metrics"]
    return (set(report["trace"]["by_name"]),
            {k: set(v) for k, v in metrics.items()},
            metrics["counters"], set(report))


@pytest.mark.parametrize("rows", [5, 21])
def test_apply_batch_records_the_references_names(rows):
    """The span and metric names a small apply_batch records (inline
    staging, so the stall histogram is deterministic), and the run
    report's keys, are the JAX package's."""
    x = np.random.default_rng(9).integers(0, 256, (rows, 4, 5, 3), np.uint8)
    ours_mf, ref_mf = _scale_models()
    ours = _recorded(telemetry, health, lambda: ours_mf.apply_batch(
        x, batch_size=8, device="cpu", prefetch=0))
    ref = _recorded(jax_telemetry, jax_health, lambda: ref_mf.apply_batch(
        x, batch_size=8, prefetch=0))
    assert ours[0] == ref[0] == {"sparkdl.compile", "sparkdl.run"}
    assert ours[1] == ref[1]
    assert ours[2] == ref[2]
    assert ours[3] <= ref[3]


def test_jitted_records_one_compile_span_per_shape():
    """On the CPU the compiled fn runs eagerly, with one
    ``sparkdl.compile`` span at each new shape and none on a repeat."""
    mf = ModelFunction(lambda vs, x: x * 2.0, None, TensorSpec((None, 3)),
                       name="compile_span")
    with telemetry.Telemetry() as tel:
        mf.apply_batch(np.ones((4, 3), np.float32), batch_size=8,
                       device="cpu")
        mf.apply_batch(np.ones((4, 3), np.float32), batch_size=8,
                       device="cpu")
        mf.apply_batch(np.ones((12, 3), np.float32), batch_size=8,
                       device="cpu")
        mf.apply_batch(np.ones((20, 3), np.float32), batch_size=16,
                       device="cpu")
    compiles = tel.tracer.spans(telemetry.SPAN_COMPILE)
    assert len(compiles) == 2  # bucket 8, then bucket 16
    assert {c["attributes"]["model"] for c in compiles} == {"compile_span"}
    assert mf.jitted("cpu") is mf.jitted(torch.device("cpu"))
    assert mf.jitted("cpu").graphs == {}


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_engine(monkeypatch):
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    # every feasible kernel site routes (to its plain version on the CPU)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    yield
    EngineConfig.restore(saved)


def test_transformer_over_chunks_matches_reference(cpu_engine):
    """``TorchImageTransformer`` over one uniform partition of 20 rows at
    ``batchSize=8`` (rungs 8, 8 and a tail of 4 padded to 8, staged ahead
    on the prefetch thread): uint8 16×20 images resized on the device to
    12×12, a ``SeparableConvBN`` (the ``sep2d`` route) and the flatten,
    against ``TPUImageTransformer`` on the same Flax block with the same
    weights. float32: max|Δ| ≤ 1e-3·max|ref|."""
    cin, cout = 3, 24
    jm = JaxSeparableConvBN(cout)
    vs = random_variables(jm, (1, 12, 12, cin), seed=13)
    tm = SeparableConvBN(cin, cout, kernel_family="xception")
    tm.load_state_dict(from_flax_variables("sep", vs))
    rng = np.random.default_rng(14)
    images = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
              for _ in range(20)]
    jdf, tdf = frames(images, [f"i{k}" for k in range(20)])
    kw = dict(inputCol="image", outputCol="f", outputMode="vector",
              batchSize=8)
    ref = column(sparkdl_tpu.TPUImageTransformer(
        modelFunction=JaxModelFunction.fromFlax(
            jm, vs, JaxTensorSpec((None, 12, 12, cin)), name="sep"), **kw),
        jdf, "f")
    mf = ModelFunction.fromModule(tm, TensorSpec((None, 12, 12, cin)),
                                  name="sep")
    streams = []
    real = pipeline.DevicePrefetcher

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            streams.append(self)

    pipeline.DevicePrefetcher = Recorded
    try:
        ours = column(sparkdl_tpu_torch.TorchImageTransformer(
            modelFunction=mf, **kw), tdf, "f")
    finally:
        pipeline.DevicePrefetcher = real
    assert ours.shape == ref.shape == (20, 12 * 12 * cout)
    assert max_abs(ours, ref) <= 1e-3 * np.abs(ref).max()
    assert [(s.depth, s.stats.staged, s.stats.consumed) for s in streams] \
        == [(2, 3, 3)]
    compiled = mf.flattened().resized((16, 20), (12, 12)).jitted("cpu")
    assert [k[0] for k in compiled._seen] == [(8, 16, 20, 3)]


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """Off without a directory; with ``SPARKDL_PROFILE_DIR`` set, a
    ``torch.profiler`` Chrome trace holding the block's annotated ranges
    lands there."""
    monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
    with profiling.maybe_trace() as on:
        assert on is False
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    with profiling.maybe_trace() as on:
        with profiling.annotate("sparkdl.decode"):
            torch.ones(4).sum()
    assert on is True
    traces = list(tmp_path.glob("sparkdl_trace_*.json"))
    assert len(traces) == 1 and "sparkdl.decode" in traces[0].read_text()


def test_telemetry_scope_writes_its_report(tmp_path):
    """The scope's run report and Chrome trace land in ``out_dir``; spans
    opened on another thread parent under the attached context; the
    Prometheus dump holds every instrument."""
    import json
    import threading

    with health.HealthMonitor("h"), \
            telemetry.Telemetry("t", out_dir=str(tmp_path)) as tel:
        with telemetry.span(telemetry.SPAN_MATERIALIZE) as outer:
            ctx = telemetry.current_context()

            def child():
                telemetry.attach(ctx)
                with telemetry.span("sparkdl.stage"):
                    pass

            worker = threading.Thread(target=child)
            worker.start()
            worker.join(timeout=10)
        telemetry.count(telemetry.M_BATCH_ROWS, 3)
        telemetry.gauge_set(telemetry.M_PADDING_WASTE, 0.25)
        telemetry.observe(telemetry.M_PREFETCH_STALL_S, 0.01)
        health.record(health.DECODE_DEGRADED)
    assert not worker.is_alive()
    stage = tel.tracer.spans("sparkdl.stage")[0]
    assert stage["parent_id"] == outer.span_id
    report = json.loads(open(tel.report_path).read())
    assert report["metrics"]["counters"] == {
        telemetry.M_BATCH_ROWS: 3,
        telemetry.HEALTH_METRIC_PREFIX + health.DECODE_DEGRADED: 1}
    assert report["health"]["counters"] == {health.DECODE_DEGRADED: 1}
    trace = json.loads(open(tel.trace_path).read())
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} == \
        {"sparkdl.run", "sparkdl.materialize", "sparkdl.stage"}
    text = tel.metrics.prometheus_text()
    for name in ("sparkdl_batching_rows 3", "sparkdl_batching_padding_waste",
                 "sparkdl_prefetch_stall_s_count 1"):
        assert name in text
    assert telemetry.active() is None
