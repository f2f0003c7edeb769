"""The port's partition supervisor against the JAX package's, and on the
port's engine.

Scripted faults go through both packages' ``run_partition_task`` and
``PartitionSupervisor.run_all`` and must give the same health events (in
order, with their context) and the same attempt kinds. The engine cases
mirror the reference's ``tests/engine/test_supervisor.py`` on the port's
``DataFrame`` (plain numpy columns; no pyarrow). Every wait is bounded
and no sleep exceeds 0.5 s.
"""

import concurrent.futures as futures
import threading
import time

import numpy as np
import pytest

from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import resilience as jax_res
from sparkdl_tpu.engine import supervisor as jax_sup
from sparkdl_tpu_torch.core import executor, health, resilience
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import (
    Fault, FaultInjector, RetryPolicy, classify,
)
from sparkdl_tpu_torch.engine import supervisor as sup
from sparkdl_tpu_torch.engine.dataframe import DataFrame, EngineConfig
from sparkdl_tpu_torch.engine.supervisor import TaskFailure

FAST = dict(max_retries=2, base_delay_s=0.0, jitter=0.0)
JOIN_S = 10.0


@pytest.fixture(autouse=True)
def _restore_engine_config():
    saved = EngineConfig.snapshot()
    yield
    EngineConfig.restore(saved)


# -- parity with the reference -----------------------------------------------


def _script(r, steps):
    """One op whose n-th call does ``steps[n]``: "ok", "sleep", or an
    exception built from resilience module ``r``."""
    calls = {"n": 0}
    lock = threading.Lock()

    def op(batch):
        with lock:
            step = steps[min(calls["n"], len(steps) - 1)]
            calls["n"] += 1
        if step == "sleep":
            time.sleep(0.06)
            return batch
        if step != "ok":
            raise step(r)
        return batch + "+"

    return op


SCRIPTS = {
    "fatal": (["fatal"], {}),
    "retried_then_ok": (["transient", "transient", "ok"], {}),
    "exhausted": (["transient"], {}),
    "oom": (["oom"], {}),
    "poison_confirmed": (["fatal"], {"max_fatal_attempts": 2}),
    "cooperative_deadline": (["sleep"] * 3, {"deadline_s": 0.1}),
}
ERRORS = {
    "fatal": lambda r: ValueError("deliberate shape error"),
    "transient": lambda r: RuntimeError("UNAVAILABLE: worker lost"),
    "oom": lambda r: r.DeviceOOM(),
}


def _run_script(pkg_sup, r, mon_cls, name):
    steps, kw = SCRIPTS[name]
    steps = [ERRORS.get(s, s) for s in steps]
    ops = [_script(r, steps)] * (3 if name == "cooperative_deadline" else 1)
    with mon_cls() as mon:
        try:
            out = pkg_sup.run_partition_task(
                4, "rows", ops, r.RetryPolicy(**FAST),
                sleep=lambda s: None, **kw)
            failure = None
        except Exception as e:  # noqa: BLE001 - compared below
            out, failure = None, e
    kinds = None if failure is None else [a.kind for a in failure.attempts]
    return (out, type(failure).__name__, kinds,
            getattr(failure, "failure_kind", None),
            getattr(failure, "deadline_exceeded", None), mon.events())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_partition_task_matches_reference(name):
    ours = _run_script(sup, resilience, HealthMonitor, name)
    ref = _run_script(jax_sup, jax_res, jax_health.HealthMonitor, name)
    assert ours == ref
    assert ours[-1][0] == {"event": health.TASK_STARTED, "partition": 4}


class _InlinePool:
    """A pool that runs each submission at once on the calling thread,
    so both packages' supervisors see the same order of events."""

    def submit(self, fn):
        fut = futures.Future()
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - delivered
            fut.set_exception(e)
        return fut


@pytest.mark.parametrize("quarantine", [False, True])
def test_run_all_matches_reference(quarantine):
    """Three partitions, one poisoned (FATAL), one flaky once: the same
    events, the same results, the same terminal failure or quarantine in
    both packages."""
    def run(pkg_sup, r, mon_cls):
        flaky = {"n": 1}

        def runner(i):
            def go(cancel):
                return pkg_sup.run_partition_task(
                    i, f"p{i}", [op(i)], r.RetryPolicy(**FAST),
                    cancelled=cancel, sleep=lambda s: None)
            return go

        def op(i):
            def f(batch):
                if i == 1:
                    raise ValueError("poisoned partition")
                if i == 2 and flaky["n"]:
                    flaky["n"] -= 1
                    raise r.TransferStall()
                return batch + "!"
            return f

        cfg = pkg_sup.SupervisorConfig(quarantine=quarantine)
        s = pkg_sup.PartitionSupervisor(_InlinePool(), cfg,
                                        quarantine_probe=lambda i: "empty")
        with mon_cls() as mon:
            try:
                out = s.run_all([(i, runner(i)) for i in range(3)])
            except Exception as e:  # noqa: BLE001 - compared below
                out = (type(e).__name__, e.failure_kind, e.index)
        return out, mon.events()

    ours = run(sup, resilience, HealthMonitor)
    ref = run(jax_sup, jax_res, jax_health.HealthMonitor)
    assert ours == ref
    if quarantine:
        assert ours[0] == ["p0!", "empty", "p2!"]
    else:
        assert ours[0] == ("TaskFailure", resilience.FATAL, 1)


# -- the port's engine -------------------------------------------------------


def make_df(n=12, parts=4):
    return DataFrame.fromColumns({"x": np.arange(n)}, numPartitions=parts)


def _map(df, fn):
    """Add column y = fn(batch) over each partition."""
    return df.withColumnBatch("y", fn)


def test_partitions_run_on_the_shared_pool_in_order():
    threads = set()
    lock = threading.Lock()

    def op(batch):
        with lock:
            threads.add(threading.current_thread().name)
        time.sleep(0.02)
        return batch.column("x") * 2

    EngineConfig.max_workers = 3
    with HealthMonitor() as mon:
        rows = _map(make_df(12, 6), op).collect()
    assert [r["y"] for r in rows] == [2 * i for i in range(12)]
    assert all(t.startswith("sparkdl-part") for t in threads)
    assert 1 < len(threads) <= 3
    assert mon.count(health.TASK_STARTED) == 6


def test_fatal_op_error_never_retried():
    calls = []

    def bad(x):
        calls.append(x)
        if x == 3:
            raise ValueError("deliberate shape error")
        return x

    with pytest.raises(TaskFailure) as ei:
        make_df(6, 3).withColumn("y", bad, ["x"]).collect()
    tf = ei.value
    assert tf.failure_kind == resilience.FATAL and tf.retries() == 0
    assert "ValueError" in tf.attempts[0].error
    assert calls.count(3) == 1
    assert classify(tf) == resilience.FATAL


@pytest.mark.parametrize("error,kind,attempts", [
    (resilience.DeviceOOM, resilience.OOM, 1),
    (lambda: RuntimeError("UNAVAILABLE: permanently lost"),
     resilience.RETRYABLE, 3),
], ids=["oom", "retryable_exhausted"])
def test_terminal_failure_carries_its_attempts(error, kind, attempts):
    EngineConfig.max_task_retries = 2

    def always(batch):
        raise error()

    with pytest.raises(TaskFailure) as ei:
        _map(make_df(4, 2), always).collect()
    assert ei.value.failure_kind == kind and classify(ei.value) == kind
    assert [a.kind for a in ei.value.attempts] == [kind] * attempts
    assert all(a.duration_s >= 0 for a in ei.value.attempts)


@pytest.mark.parametrize("arming", ["start", "finish", "legacy"])
def test_injected_task_faults_recover_via_retry(arming):
    calls = []
    lock = threading.Lock()

    def track(batch):
        with lock:
            calls.append(batch.num_rows)
        return batch.column("x") + 1

    df = _map(make_df(6, 2), track)
    with HealthMonitor() as mon:
        if arming == "legacy":
            seen = []

            def injector(pidx, attempt):
                seen.append((pidx, attempt))
                if pidx == 1 and attempt == 0:
                    raise RuntimeError("transient")

            EngineConfig.fault_injector = injector
            rows = df.collect()
            assert (1, 0) in seen and (1, 1) in seen
        else:
            with FaultInjector.seeded(0, engine_task=Fault(
                    times=1, when=lambda c: c.get("phase") == arming)) as inj:
                rows = df.collect()
            assert inj.fired["engine_task"] == 1
    assert [r["y"] for r in rows] == [i + 1 for i in range(6)]
    assert mon.count(health.TASK_RETRIED) == 1
    # a "finish" fault discards a computed attempt: one partition twice
    assert len(calls) == (3 if arming == "finish" else 2)


def test_stalled_task_fails_via_the_watchdog_and_counts_once():
    EngineConfig.task_timeout_s = 0.2
    df = _map(make_df(6, 3), lambda b: b.column("x"))
    t0 = time.monotonic()
    with FaultInjector.seeded(0, task_stall=Fault(
            when=lambda c: c["partition"] == 1)) as inj:
        with HealthMonitor() as mon:
            with pytest.raises(TaskFailure, match="deadline") as ei:
                df.collect()
            time.sleep(0.5)  # outlive the stalled thread's wake-up
    assert time.monotonic() - t0 < 5.0
    assert inj.fired["task_stall"] == 1
    assert ei.value.failure_kind == resilience.FATAL
    assert mon.count(health.TASK_DEADLINE_EXCEEDED) == 1
    assert mon.events(health.TASK_DEADLINE_EXCEEDED)[0]["partition"] == 1
    assert mon.count(health.TASK_RETRIED) == 0


def test_straggler_hedged_first_result_wins_and_loser_bails():
    EngineConfig.speculation = True
    EngineConfig.speculation_quantile = 0.5
    EngineConfig.speculation_min_runtime_s = 0.05
    EngineConfig.max_workers = 9
    ran = set()
    lock = threading.Lock()

    def op(batch):
        first = int(batch.column("x")[0])
        with lock:
            hedge_run = first in ran
            ran.add(first)
        if first == 15 and not hedge_run:
            time.sleep(0.5)
            raise RuntimeError("UNAVAILABLE: straggler worker lost")
        return batch.column("x")

    df = make_df(18, 6)
    t0 = time.monotonic()
    with HealthMonitor() as mon:
        rows = _map(df, op).collect()
        elapsed = time.monotonic() - t0
        time.sleep(0.5)  # outlive the loser with the monitor active
    assert [r["y"] for r in rows] == list(range(18))
    assert elapsed < 0.45
    assert mon.count(health.TASK_HEDGED) == 1
    assert mon.count(health.HEDGE_WON) == 1
    assert mon.events(health.TASK_HEDGED)[0]["partition"] == 5
    assert mon.count(health.TASK_FAILED) == 0
    assert mon.count(health.TASK_RETRIED) == 0


def _poison(x):
    if 3 <= x < 6:  # partition 1's rows
        raise ValueError(f"poisoned row {x}")
    return x * 10


@pytest.mark.parametrize("max_fatal", [1, 2])
def test_quarantine_drops_poisoned_partition_and_records(max_fatal):
    EngineConfig.quarantine = True
    EngineConfig.quarantine_max_fatal = max_fatal
    with HealthMonitor() as mon:
        out = make_df(9, 3).withColumn("y", _poison, ["x"])
        rows = out.collect()
    assert [r["x"] for r in rows] == [0, 1, 2, 6, 7, 8]
    assert [r["y"] for r in rows] == [0, 10, 20, 60, 70, 80]
    assert [b.num_rows for b in out._materialize()] == [3, 0, 3]
    assert all("y" in b.columns for b in out._materialize())
    (entry,) = mon.quarantined()
    assert entry["partition"] == 1
    assert entry["attempts"] == [resilience.FATAL] * max_fatal


@pytest.mark.parametrize("case", ["off", "deadline", "retryable"])
def test_quarantine_applies_to_poison_only(case):
    EngineConfig.quarantine = case != "off"
    if case == "off":
        df = make_df(9, 3).withColumn("y", _poison, ["x"])
    elif case == "deadline":
        EngineConfig.task_timeout_s = 0.15

        def slow(batch):
            time.sleep(0.05)
            return batch.column("x")

        df = make_df(4, 1)
        for i in range(4):  # the budget runs out between ops
            df = df.withColumnBatch(f"y{i}", slow)
    else:
        EngineConfig.max_task_retries = 1

        def flaky(batch):
            raise RuntimeError("UNAVAILABLE: still down")

        df = _map(make_df(4, 2), flaky)
    with HealthMonitor() as mon:
        with pytest.raises(TaskFailure) as ei:
            df.collect()
    assert mon.count(health.TASK_QUARANTINED) == 0
    if case == "deadline":
        assert ei.value.deadline_exceeded
        assert mon.count(health.TASK_DEADLINE_EXCEEDED) == 1


def test_nested_materialization_from_a_partition_runs_inline():
    """A frame collected from inside a partition task runs inline on
    that pool thread instead of waiting on the pool it occupies."""
    EngineConfig.max_workers = 1
    inner = _map(make_df(4, 2), lambda b: b.column("x") + 100)

    def op(batch):
        rows = inner.collect()
        return np.full(batch.num_rows, sum(r["y"] for r in rows))

    rows = _map(make_df(2, 2), op).collect()
    assert [r["y"] for r in rows] == [406, 406]


def test_retry_loop_attempt_restarts_executor_call_sequence():
    seen = []
    failures = {"n": 1}

    def device_call(batch):
        seen.append(executor.current_task_token())
        if failures["n"] > 0:
            failures["n"] -= 1
            raise RuntimeError("UNAVAILABLE: transient")
        return batch

    with executor.task_scope(("task", 7, 0)):
        out = sup.run_partition_task(0, "rows", [device_call, device_call],
                                     RetryPolicy(**FAST))
    assert out == "rows"
    assert seen == [("task", 7, 0, 0), ("task", 7, 0, 0),
                    ("task", 7, 0, 1)]
