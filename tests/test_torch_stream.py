"""``DataFrame.streamPartitions`` and the supervisor's streaming mode in
the port, against the JAX package's and on the port's engine, on the CPU.

The engine cases mirror the reference's (``tests/engine/
test_supervisor.py``'s streaming cases, ``tests/engine/test_dataframe.py``'s
order case, ``tests/ml/test_estimator.py``'s caching and in-flight cases)
on the port's ``DataFrame`` of plain numpy columns; where the reference's
frame computes the same thing, its stream is run too and must agree. The
featurized stream is TestNet (32×32, 16 features), float32, with the same
weights in both packages: max|Δ| ≤ 1e-3·max|ref|. Every wait is bounded
and no sleep exceeds 0.1 s.
"""

import threading
import time

import numpy as np
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.engine.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.core import executor, health
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import FaultInjector
from sparkdl_tpu_torch.engine.dataframe import DataFrame, EngineConfig
from sparkdl_tpu_torch.image import imageIO
from tests.torch_port_helpers import (
    frames, headless, max_abs, random_variables,
)

F32_REL = 1e-3
N, PARTS = 12, 6


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 3
    executor.reset()
    yield
    executor.reset()
    EngineConfig.restore(saved)


def _numbers(n=12, parts=4):
    """A frame of ``v`` = 0..n-1 in ``parts`` partitions with ``w = v+1``
    added lazily, in both packages."""
    cols = {"v": np.arange(n, dtype=np.int64)}
    ours = DataFrame.fromColumns(cols, numPartitions=parts)
    ref = JaxDataFrame.fromColumns(cols, numPartitions=parts)
    return (ours.withColumn("w", lambda v: v + 1, inputCols=["v"]),
            ref.withColumn("w", lambda v: v + 1, inputCols=["v"]))


def _values(batch, name="v"):
    col = batch.column(name)
    return col.to_pylist() if hasattr(col, "to_pylist") else list(
        np.asarray(col).tolist())


def _stream(df, **kw):
    return [_values(b) for b in df.streamPartitions(**kw)]


# -- rows, order, sharding ----------------------------------------------------


def test_streamed_features_match_reference_stream():
    """TestNet's featurized frame streamed in both packages, naturally,
    in a permuted order and as one process's share: the same partitions
    in the same order, each row within tolerance."""
    variables = headless(random_variables(
        jax_testnet.TestNet(include_top=True), (1, 32, 32, 3), seed=71))
    rng = np.random.default_rng(72)
    images = [rng.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
              for _ in range(N)]
    origins = [f"img{i}" for i in range(N)]
    jdf, _ = frames(images, origins)
    jdf = sparkdl_tpu.DataFrame.fromArrow(jdf.toArrow(), numPartitions=PARTS)
    tdf = DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(images, origins)},
        numPartitions=PARTS)
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              weights=variables, batchSize=8)
    ours = sparkdl_tpu_torch.DeepImageFeaturizer(**kw).transform(tdf)
    saved = JaxEngineConfig.snapshot()
    JaxEngineConfig.max_workers = 3
    try:
        ref = sparkdl_tpu.DeepImageFeaturizer(**kw).transform(jdf)
        streams = [dict(), dict(order=[4, 1, 5, 0, 3, 2]),
                   dict(order=[4, 1, 5, 0, 3, 2], process_id=1,
                        num_processes=2)]
        want = [[np.asarray(b.column("features").to_pylist(), np.float32)
                 for b in ref.streamPartitions(**s)] for s in streams]
    finally:
        JaxEngineConfig.restore(saved)
    got = [[np.asarray(b.column("features"), np.float32)
            for b in ours.streamPartitions(**s)] for s in streams]
    assert [len(p) for p in got] == [len(p) for p in want] == [6, 6, 3]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape == (2, 16)
            assert max_abs(a, b) <= F32_REL * np.abs(b).max()
    # the share and the order pick the same partitions as the full stream
    assert all(np.array_equal(got[1][i], got[0][p])
               for i, p in enumerate([4, 1, 5, 0, 3, 2]))
    assert all(np.array_equal(got[2][i], got[1][1 + 2 * i])
               for i in range(3))


def test_stream_order_and_sharding_match_reference():
    ours, ref = _numbers()
    natural = _stream(ours)
    assert natural == _stream(ref) == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                       [9, 10, 11]]
    order = [2, 0, 3, 1]
    assert _stream(ours, order=order) == _stream(ref, order=order) \
        == [natural[i] for i in order]
    for p in range(3):
        kw = dict(order=order, process_id=p, num_processes=3)
        assert _stream(ours, **kw) == _stream(ref, **kw) \
            == [natural[i] for i in order[p::3]]
    for bad in (None, -1, 3):
        with pytest.raises(ValueError, match="process_id"):
            _stream(ours, process_id=bad, num_processes=3)
    # a cached frame honors the order too, from its cached partitions
    cached = ours.cache()
    assert cached is ours
    assert _stream(ours, order=order) == [natural[i] for i in order]
    assert [_values(b, "w") for b in ours.streamPartitions()] == \
        [[v + 1 for v in part] for part in natural]


def test_stream_does_not_cache():
    calls = []
    df = DataFrame.fromColumns({"v": np.arange(8, dtype=np.int64)},
                               numPartitions=4)
    df = df.withColumnBatch("n", lambda b: calls.append(1) or np.full(
        b.num_rows, len(calls)))
    first = [b.num_rows for b in df.streamPartitions()]
    assert df._materialized is None  # nothing cached
    second = [b.num_rows for b in df.streamPartitions()]
    assert first == second == [2, 2, 2, 2]
    assert len(calls) == 8  # recomputed on the second pass
    # a frame without ops yields its source partitions
    plain = DataFrame.fromColumns({"v": np.arange(4)}, numPartitions=2)
    assert [b is p for b, p in zip(plain.streamPartitions(),
                                   plain._partitions)] == [True, True]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_in_flight_at_most_prefetch_plus_one(prefetch):
    """Partitions started but not yet yielded never exceed prefetch + 1,
    on a pool wider than that."""
    EngineConfig.max_workers = 8
    lock = threading.Lock()
    state = {"started": 0, "yielded": 0, "peak": 0}

    def op(batch):
        with lock:
            state["started"] += 1
            state["peak"] = max(state["peak"],
                                state["started"] - state["yielded"])
        time.sleep(0.01)
        return batch

    df = DataFrame.fromColumns({"v": np.arange(16)}, numPartitions=8)
    df = df.withColumnBatch("v2", lambda b: op(b).column("v"))
    seen = []
    for batch in df.streamPartitions(prefetch=prefetch):
        with lock:
            state["yielded"] += 1
        seen.append(_values(batch)[0])
        time.sleep(0.005)
    assert seen == list(range(0, 16, 2))
    assert 0 < state["peak"] <= prefetch + 1


# -- abandonment, quarantine, faults ------------------------------------------


@pytest.mark.parametrize("how", ["close", "break"])
def test_early_stop_cancels_unstarted_partitions(how):
    """An abandoned stream (closed, or left by a ``break``) cancels the
    partitions not yet started and waits for the running ones: with one
    worker and prefetch 4, only the yielded head and what was running can
    have run."""
    EngineConfig.max_workers = 1  # narrow pool: the window queues
    executed = []
    lock = threading.Lock()

    def op(batch):
        with lock:
            executed.append(_values(batch)[0])
        time.sleep(0.05)
        return batch.column("v")

    df = DataFrame.fromColumns({"v": np.arange(12)},
                               numPartitions=6).withColumnBatch("w", op)
    with HealthMonitor() as mon:
        if how == "close":
            gen = df.streamPartitions(prefetch=4)
            next(gen)
            gen.close()
        else:
            for _ in df.streamPartitions(prefetch=4):
                break
        with lock:
            n = len(executed)
    assert n <= 3
    assert mon.count(health.TASK_STARTED) == n
    time.sleep(0.1)
    with lock:
        assert len(executed) == n  # nothing ran after the drain


def _poisoned(n=9, parts=3, bad=range(3, 6)):
    def op(v):
        if v in bad:
            raise ValueError(f"poisoned row {v}")
        return v

    df = DataFrame.fromColumns({"v": np.arange(n, dtype=np.int64)},
                               numPartitions=parts)
    return df.withColumn("y", op, inputCols=["v"])


def test_quarantine_streaming_yields_empty_standin():
    EngineConfig.quarantine = True
    with HealthMonitor() as mon:
        parts = list(_poisoned().streamPartitions())
    assert [p.num_rows for p in parts] == [3, 0, 3]
    assert all("y" in p.columns for p in parts)
    assert mon.count(health.TASK_QUARANTINED) == 1
    assert mon.quarantined()[0]["partition"] == 1


def test_stream_order_and_sharding_survive_injected_faults():
    """A failing-then-recovering task on one 'host' must not change the
    round-robin assignment or the order of its partitions."""
    df = DataFrame.fromColumns({"v": np.arange(24, dtype=np.int64)},
                               numPartitions=8)
    df = df.withColumn("w", lambda v: v + 1, inputCols=["v"])
    order = [5, 2, 7, 0, 3, 6, 1, 4]

    def share(p):
        return _stream(df, order=order, process_id=p, num_processes=3)

    clean = {p: share(p) for p in range(3)}
    inj = FaultInjector.seeded(0, engine_task=2)
    faulted = {}
    for p in range(3):
        if p == 1:
            with inj, HealthMonitor() as mon:
                faulted[p] = share(p)
        else:
            faulted[p] = share(p)
    assert inj.fired["engine_task"] == 2
    assert mon.count(health.TASK_RETRIED) == 2
    assert faulted == clean
    seen = sorted(v for host in faulted.values() for part in host
                  for v in part)
    assert seen == list(range(24))
    natural = _stream(df)
    for p in range(3):
        assert faulted[p] == [natural[i] for i in order[p::3]]


def test_sharded_stream_quarantine_degrades_only_owning_host():
    EngineConfig.quarantine = True
    df = _poisoned(12, 4, bad=(3,))
    host0 = [_values(b) for b in df.streamPartitions(process_id=0,
                                                     num_processes=2)]
    host1 = [_values(b) for b in df.streamPartitions(process_id=1,
                                                     num_processes=2)]
    assert host0 == [[0, 1, 2], [6, 7, 8]]  # untouched
    assert host1 == [[], [9, 10, 11]]  # partition 1 dropped, order kept


def test_stream_from_a_partition_thread_runs_inline():
    """A stream started inside a partition task runs on that thread:
    waiting on the shared pool from one of its own threads could
    deadlock."""
    inner = DataFrame.fromColumns({"v": np.arange(6)}, numPartitions=3)
    threads = []
    inner = inner.withColumnBatch(
        "t", lambda b: threads.append(threading.current_thread().name)
        or b.column("v"))

    def outer_op(batch):
        rows = sum(b.num_rows for b in inner.streamPartitions(prefetch=2))
        return np.full(batch.num_rows, rows)

    outer = DataFrame.fromColumns({"v": np.arange(2)}, numPartitions=1)
    got = outer.withColumnBatch("rows", outer_op).collect()
    assert [r["rows"] for r in got] == [6, 6]
    assert len(threads) == 3 and len(set(threads)) == 1
    assert threads[0].startswith("sparkdl-part")


# -- partitionsIter, foreachPartition, isEmpty, cache -------------------------


def test_partitions_iter_foreach_is_empty_and_cache():
    calls = []
    df = DataFrame.fromColumns({"v": np.arange(6)}, numPartitions=3)
    df = df.withColumnBatch("w", lambda b: calls.append(1) or b.column("v"))
    assert [_values(b) for b in df.partitionsIter()] == [[0, 1], [2, 3],
                                                         [4, 5]]
    seen = []
    df.foreachPartition(lambda b: seen.append(_values(b, "w")))
    assert seen == [[0, 1], [2, 3], [4, 5]]
    assert len(calls) == 3  # materialized once, reused
    assert not df.isEmpty()
    empty = DataFrame.fromColumns({"v": np.arange(0)})
    assert empty.withColumnBatch("w", lambda b: b.column("v")).isEmpty()
    fresh = DataFrame.fromColumns({"v": np.arange(4)}, numPartitions=2)
    fresh = fresh.withColumnBatch("w", lambda b: calls.append(1)
                                  or b.column("v"))
    assert fresh.cache() is fresh and len(calls) == 5
    cached = list(fresh.streamPartitions())
    assert [a is b for a, b in zip(cached, fresh._materialized)] == [True,
                                                                     True]
    assert fresh.count() == 4 and len(calls) == 5
