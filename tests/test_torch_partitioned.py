"""The slice as a whole: ``DeepImageFeaturizer`` over a frame of many
partitions, run on the supervised partition pool with the coalescing
executor, against the same frame in one partition, with coalescing off,
and against the JAX package's featurizer over its own engine.

TestNet (32×32, 16 features) with the same random weights in both
packages; 12 uint8 images of 40×36 (resized on the device) in 6
partitions, ``max_workers = 3``, float32, on the CPU. On the CPU the
toy-sized coalesced forward is bit-identical to per-partition forwards,
so the port's runs must be equal to each other; against the reference
the float32 slice tolerance holds: max|Δ| ≤ 1e-3·max|ref|.
"""

import numpy as np
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.core import executor, health, telemetry
from sparkdl_tpu_torch.engine.dataframe import DataFrame, EngineConfig
from sparkdl_tpu_torch.image import imageIO
from tests.torch_port_helpers import (
    column, frames, headless, max_abs, random_variables,
)

F32_REL = 1e-3
N, PARTS = 12, 6


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 3
    EngineConfig.coalesce_window_ms = 100.0
    executor.reset()
    yield
    executor.reset()
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def variables():
    return random_variables(jax_testnet.TestNet(include_top=True),
                            (1, 32, 32, 3), seed=61)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(62)
    return [rng.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
            for _ in range(N)]


@pytest.fixture(scope="module")
def featurizer(variables):
    return sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="TestNet",
        weights=headless(variables), batchSize=8)


def _frame(images, parts, extra=None):
    cols = {"image": imageIO.imageArraysToStructColumn(
        images, [f"img{i}" for i in range(len(images))])}
    cols.update(extra or {})
    return DataFrame.fromColumns(cols, numPartitions=parts)


def _features(featurizer, df):
    return column(featurizer, df, "features")


def test_partitioned_featurize_coalesces_and_equals_uncoalesced(
        featurizer, images):
    with telemetry.Telemetry() as tel, health.HealthMonitor() as mon:
        coalesced = _features(featurizer, _frame(images, PARTS))
    EngineConfig.coalesce = False
    plain = _features(featurizer, _frame(images, PARTS))
    assert coalesced.shape == (N, 16) and np.isfinite(coalesced).all()
    assert np.array_equal(coalesced, plain)
    hists = tel.metrics.snapshot()["histograms"]
    assert hists[telemetry.M_COALESCE_REQUESTS]["max"] >= 2
    assert mon.count(health.TASK_STARTED) == PARTS
    assert mon.count(health.TASK_FAILED) == 0


def test_partitioned_featurize_equals_one_partition(featurizer, images):
    many = _features(featurizer, _frame(images, PARTS))
    one = _features(featurizer, _frame(images, 1))
    assert np.array_equal(many, one)


def test_partitioned_featurize_matches_reference(variables, featurizer,
                                                 images):
    jdf, _ = frames(images, [f"img{i}" for i in range(N)])
    jdf = sparkdl_tpu.DataFrame.fromArrow(jdf.toArrow(), numPartitions=PARTS)
    saved = JaxEngineConfig.snapshot()
    JaxEngineConfig.max_workers = 3
    try:
        ref = column(sparkdl_tpu.DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="TestNet",
            weights=headless(variables), batchSize=8), jdf, "features")
    finally:
        JaxEngineConfig.restore(saved)
    ours = _features(featurizer, _frame(images, PARTS))
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()


def test_ambient_scopes_reach_execute_from_partition_threads(
        featurizer, images, monkeypatch):
    """Each partition's device call runs on a pool thread inside its
    task's token and deadline scopes, and resolves its tenant there."""
    import threading

    EngineConfig.task_timeout_s = 30.0
    EngineConfig.executor_default_tenant = "jobA"
    seen = []
    orig = executor.execute

    def spy(*args, **kwargs):
        seen.append((threading.current_thread().name,
                     executor._tls.__dict__.get("token"),
                     executor.current_deadline(),
                     executor.current_tenant()))
        return orig(*args, **kwargs)

    submitted = []
    service = executor.service()
    orig_submit = service.submit

    def spy_submit(*args, **kwargs):
        submitted.append(kwargs["tenant"])
        return orig_submit(*args, **kwargs)

    monkeypatch.setattr(executor, "execute", spy)
    monkeypatch.setattr(service, "submit", spy_submit)
    _features(featurizer, _frame(images, PARTS))
    assert len(seen) == PARTS
    for thread, token, deadline, tenant in seen:
        assert thread.startswith("sparkdl-part")
        assert token[0] == "task"
        assert deadline is not None and deadline.timeout_s == 30.0
        assert tenant is None  # no scope: the knob's default applies
    assert len({token for _, token, _, _ in seen}) == PARTS
    assert submitted == ["jobA"] * PARTS


def test_quarantined_partition_keeps_ragged_null_cells(featurizer, images):
    """A ragged frame (mixed sizes, one null image) of three partitions,
    the middle one poisoned by an op before the featurizer: with
    quarantine on, its rows drop, and the other partitions keep their
    features and their null cell."""
    EngineConfig.quarantine = True
    ragged = list(images[:9])
    ragged[1] = None
    ragged[4] = images[4][:36, :30]
    ids = np.arange(9)
    df = _frame(ragged, 3, {"id": ids})

    def check(i):
        if 3 <= i < 6:
            raise ValueError(f"poisoned row {i}")
        return i

    out = featurizer.transform(df.withColumn("ok", check, ["id"]))
    with health.HealthMonitor() as mon:
        rows = out.collect()
    assert [r["id"] for r in rows] == [0, 1, 2, 6, 7, 8]
    assert rows[1]["features"] is None
    clean = featurizer.transform(df).collect()  # no poison, no drop
    for r in rows:
        want = clean[r["id"]]["features"]
        if want is None:
            assert r["features"] is None
        else:
            assert np.array_equal(r["features"], want)
    (entry,) = mon.quarantined()
    assert entry["partition"] == 1
