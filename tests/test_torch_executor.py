"""The port's device execution service on the CPU: the reference's
executor and overload cases (``tests/core/test_executor.py``,
``tests/core/test_overload.py``) ported to a row-wise toy
``ModelFunction``, where coalesced outputs must be bit-identical to
per-request ``apply_batch`` and in order.

``sleep_s`` makes a forward hold the device for a while (it holds the
port's weights lock, so every other forward waits behind it, as launches
queue behind a busy card). Every thread join and future wait is bounded
and no sleep here exceeds 0.5 s. The pytree-input and mesh cases of the
reference are left out with the features they test.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import executor, health, resilience, telemetry
from sparkdl_tpu_torch.core.executor import (
    ExecutorCircuitOpen, ExecutorOverloaded, ExecutorShutdown, task_scope,
)
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.core.resilience import (
    Deadline, Fault, FaultInjector, RetryPolicy,
)
from sparkdl_tpu_torch.core.telemetry import Telemetry
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.engine.supervisor import run_partition_task

_ELEMENT = (6,)
_FEATURES = 3
JOIN_S = 10.0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_executor():
    """Each test gets its own service instance and pristine knobs."""
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    executor.reset()
    yield
    executor.reset()
    EngineConfig.restore(saved)


def _model(name="exec_model", sleep_s=0.0, fail_flag=None, hook=None):
    """Row-wise model: ``sleep_s`` holds a forward in flight;
    ``fail_flag`` (a mutable [bool]) makes a forward fail FATALLY while
    set; ``hook(x)`` runs on each chunk first."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(_ELEMENT[0], _FEATURES))
                         .astype(np.float32))

    def apply_fn(vs, x):
        if hook is not None:
            hook(x)
        if sleep_s:
            time.sleep(sleep_s)
        if fail_flag is not None and fail_flag[0]:
            raise ValueError("INVALID_ARGUMENT: deliberate terminal failure")
        return torch.tanh(x @ vs)

    return ModelFunction(apply_fn, w, TensorSpec((None,) + _ELEMENT),
                         name=name)


def _rows(n, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n,) + _ELEMENT).astype(np.float32)


def _apply(mf, x, batch_size=32, **kw):
    return mf.apply_batch(x, batch_size=batch_size, device="cpu", **kw)


def _join(*threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), f"{t.name} did not finish in time"


def _start(target, *args, name=None):
    t = threading.Thread(target=target, args=args, name=name)
    t.start()
    return t


def _run_concurrent(mf, inputs, batch_size=32, **kw):
    """Submit every input from its own thread (barrier start); returns
    the per-thread results and errors in input order."""
    results = [None] * len(inputs)
    errors = [None] * len(inputs)
    barrier = threading.Barrier(len(inputs), timeout=JOIN_S)

    def work(i):
        try:
            barrier.wait()
            results[i] = executor.execute(mf, inputs[i],
                                          batch_size=batch_size, **kw)
        except BaseException as e:  # noqa: BLE001 - asserted by caller
            errors[i] = e

    _join(*[_start(work, i) for i in range(len(inputs))])
    return results, errors


def _record_apply_threads(mf):
    """Record which thread ran each ``apply_batch``; returns (log, the
    original apply_batch)."""
    log = []
    orig = mf.apply_batch

    def recording(array, *args, **kwargs):
        log.append(threading.current_thread().name)
        return orig(array, *args, **kwargs)

    mf.apply_batch = recording
    return log, orig


def _histograms(tel):
    return tel.metrics.snapshot()["histograms"]


# ---------------------------------------------------------------------------
# Routing and the inline fast path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["float64_rows", "uint8_images"])
def test_staged_bytes_count_the_input_as_given(case):
    """``sparkdl.executor.staged_bytes`` counts the input as the caller
    gave it, before the staging cast, as the reference's ``execute``
    does: a float64 batch fed to a float32 model counts 8 bytes an
    element in both packages (not the 4 of its staged copy); a uint8
    image batch counts its raw pixels."""
    import jax.numpy as jnp

    from sparkdl_tpu.core import executor as jax_executor
    from sparkdl_tpu.core import telemetry as jax_telemetry
    from sparkdl_tpu.core.model_function import (
        ModelFunction as JaxModelFunction, TensorSpec as JaxTensorSpec,
    )
    from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig

    if case == "float64_rows":
        x = _rows(9).astype(np.float64)
        w = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
        ours = _model()
        ref = JaxModelFunction(lambda vs, a: jnp.tanh(a @ vs), w,
                               JaxTensorSpec((None, 6)), name="exec_model")
    else:
        x = np.random.default_rng(2).integers(0, 256, (5, 4, 4, 3),
                                              dtype=np.uint8)
        ours = ModelFunction(lambda vs, a: a.reshape(a.shape[0], -1),
                             None, TensorSpec((None, 4, 4, 3)), name="flat")
        ref = JaxModelFunction(lambda vs, a: a.reshape(a.shape[0], -1),
                               None, JaxTensorSpec((None, 4, 4, 3)),
                               name="flat")
    with Telemetry() as tel:
        executor.execute(ours, x, batch_size=16)
    saved = JaxEngineConfig.snapshot()
    JaxEngineConfig.inference_precision = "float32"
    try:
        with jax_telemetry.Telemetry() as jax_tel:
            jax_executor.execute(ref, x, batch_size=16)
    finally:
        jax_executor.reset()
        JaxEngineConfig.restore(saved)
    counted = tel.metrics.snapshot()["counters"][telemetry.M_STAGED_BYTES]
    want = jax_tel.metrics.snapshot()["counters"][
        jax_telemetry.M_STAGED_BYTES]
    assert counted == want == x.nbytes


def test_solo_request_takes_inline_path_and_matches_apply_batch():
    mf = _model()
    x = _rows(5)
    with Telemetry() as tel:
        out = executor.execute(mf, x, batch_size=16)
    np.testing.assert_array_equal(out, _apply(mf, x, 16))
    hists = _histograms(tel)
    assert telemetry.M_COALESCE_REQUESTS not in hists
    assert telemetry.M_QUEUE_WAIT_S not in hists


@pytest.mark.parametrize("case", ["coalesce_off", "oversize", "empty",
                                  "over_max_rows"])
def test_requests_that_bypass_the_service(case):
    mf = _model()
    x = {"oversize": _rows(40), "empty": _rows(0)}.get(case, _rows(6))
    if case == "coalesce_off":
        EngineConfig.coalesce = False
    if case == "over_max_rows":
        EngineConfig.coalesce_max_rows = 4
    with Telemetry() as tel:
        out = executor.execute(mf, x, batch_size=16)
    np.testing.assert_array_equal(out, _apply(mf, x, 16))
    assert out.shape == (len(x), _FEATURES)
    assert telemetry.M_COALESCE_REQUESTS not in _histograms(tel)


# ---------------------------------------------------------------------------
# Coalescing: bit-identical, order-preserving, observable
# ---------------------------------------------------------------------------


def test_concurrent_requests_coalesce_bit_identical_per_requester():
    mf = _model(sleep_s=0.05)
    EngineConfig.coalesce_window_ms = 150.0
    inputs = [_rows(3, seed=i) for i in range(6)]
    expected = [_apply(mf, x) for x in inputs]
    with Telemetry() as tel:
        results, errors = _run_concurrent(mf, inputs)
    assert errors == [None] * 6
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)
    hists = _histograms(tel)
    assert hists[telemetry.M_COALESCE_REQUESTS]["max"] >= 2
    assert hists[telemetry.M_COALESCE_ROWS]["count"] >= 1
    assert hists[telemetry.M_QUEUE_WAIT_S]["count"] >= 2
    assert hists[telemetry.M_LAUNCH_S]["count"] >= 1


def test_a_coalesced_window_is_one_forward_of_the_padded_bucket():
    """Five requests queued behind a busy one drain as ONE forward over
    their rows concatenated in submission order and padded to the
    bucket (15 rows → 16)."""
    seen = []
    mf = _model(sleep_s=0.1, hook=lambda x: seen.append(x.shape[0]))
    EngineConfig.coalesce_window_ms = 200.0
    outcome = {}

    def run(name, x):
        outcome[name] = executor.execute(mf, x, batch_size=32)

    inputs = [_rows(3, seed=i) for i in range(5)]
    busy = _start(run, "busy", _rows(2, seed=9))
    time.sleep(0.03)
    threads = [_start(run, i, x) for i, x in enumerate(inputs)]
    _join(busy, *threads)
    assert seen == [8, 16]  # the busy solo rung, then one window
    for i, x in enumerate(inputs):
        np.testing.assert_array_equal(outcome[i], _apply(mf, x))


def test_a_window_records_its_launch_time_before_delivering(monkeypatch):
    """The coalescer records a window's launch time before it delivers
    any of the window's results, so a requester that tears its telemetry
    scope down as soon as its rows arrive still finds the launch: while
    the launch time is recorded, no queued requester may have returned."""
    mf = _model(sleep_s=0.1)
    EngineConfig.coalesce_window_ms = 200.0
    returned = threading.Event()
    returned_before_record = []
    observe = telemetry.observe

    def observing(name, *args, **kwargs):
        if name == telemetry.M_LAUNCH_S:
            returned_before_record.append(returned.wait(0.3))
        return observe(name, *args, **kwargs)

    monkeypatch.setattr(telemetry, "observe", observing)
    inputs = [_rows(3, seed=i) for i in range(2)]
    outcome = {}

    def run(name, x):
        outcome[name] = executor.execute(mf, x, batch_size=32)
        if name != "busy":
            returned.set()

    with Telemetry() as tel:
        busy = _start(run, "busy", _rows(2, seed=9))
        time.sleep(0.03)
        _join(busy, *[_start(run, i, x) for i, x in enumerate(inputs)])
    assert returned_before_record and not any(returned_before_record)
    assert _histograms(tel)[telemetry.M_LAUNCH_S]["count"] >= 1
    for i, x in enumerate(inputs):
        np.testing.assert_array_equal(outcome[i], _apply(mf, x))


def test_hedged_duplicate_dedups_before_coalescing():
    mf = _model(sleep_s=0.15)
    EngineConfig.coalesce_window_ms = 250.0
    x_task = _rows(3, seed=1)
    expected = _apply(mf, x_task)
    token = ("task", 1234, 7)
    results, errors = {}, []

    def busy():
        results["busy"] = executor.execute(mf, _rows(2, seed=0),
                                           batch_size=32)

    def attempt(name):
        try:
            with task_scope(token):
                results[name] = executor.execute(mf, x_task, batch_size=32)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    with Telemetry() as tel:
        t_busy = _start(busy)
        time.sleep(0.05)
        t_a = _start(attempt, "primary")
        time.sleep(0.02)
        t_b = _start(attempt, "hedge")
        _join(t_busy, t_a, t_b)
    assert not errors
    np.testing.assert_array_equal(results["primary"], expected)
    np.testing.assert_array_equal(results["hedge"], expected)
    snap = tel.metrics.snapshot()
    assert snap["counters"][telemetry.M_COALESCE_DEDUP] == 1
    assert snap["histograms"][telemetry.M_COALESCE_ROWS]["sum"] == 3


# ---------------------------------------------------------------------------
# Failure semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point,event,policy", [
    ("device_oom", health.OOM_RECHUNK, None),
    ("transfer_stall", health.CHUNK_RETRY, None),
    ("transfer_stall", None, RetryPolicy(max_retries=0)),
], ids=["oom", "transient", "transient_no_retry"])
def test_failed_coalesced_launch_splits_per_request(point, event, policy):
    """A failure of the coalesced launch (fires only on a multi-request
    window) hands every request back to its own thread: all complete,
    bit-identical; an OOM records one re-chunk, a transient one chunk
    retry — none when the caller's policy allows no retry."""
    mf = _model(sleep_s=0.05)
    EngineConfig.coalesce_window_ms = 150.0
    inputs = [_rows(3, seed=i) for i in range(5)]
    expected = [_apply(mf, x) for x in inputs]
    apply_log, _ = _record_apply_threads(mf)
    inj = FaultInjector.seeded(0, **{point: Fault(
        times=1, when=lambda c: c.get("valid", 0) >= 6)})
    kw = {} if policy is None else {"retry_policy": policy}
    with inj, HealthMonitor() as mon:
        results, errors = _run_concurrent(mf, inputs, **kw)
    assert errors == [None] * 5
    assert inj.fired[point] == 1
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)
    if event is not None:
        assert mon.count(event) == 1
    else:
        assert mon.counters() == {}
    assert not any(n.startswith("sparkdl-exec") for n in apply_log)


def test_fatal_failure_poisons_only_its_own_request():
    def poison(x):
        time.sleep(0.05)
        if torch.isnan(x).any():
            raise ValueError("INVALID_ARGUMENT: deliberate poison row")

    mf = _model(name="poison", hook=poison)
    EngineConfig.coalesce_window_ms = 150.0
    inputs = [_rows(3, seed=i) for i in range(4)]
    inputs[2] = inputs[2].copy()
    inputs[2][1, 0] = np.nan
    results, errors = _run_concurrent(mf, inputs)
    assert resilience.classify(errors[2]) == resilience.FATAL
    for i in (0, 1, 3):
        assert errors[i] is None, errors[i]
        np.testing.assert_array_equal(results[i], _apply(mf, inputs[i]))


def test_fetch_time_failure_replays_the_request_alone():
    """A failure that surfaces only at the requester's copy to the host
    is classified, and THIS request re-runs alone through apply_batch."""
    mf = _model()
    x = _rows(3, seed=5)
    svc = executor.service()
    state = svc._state(mf.jitted("cpu"), mf, 32, CPU)

    class _LateBoom:
        dtype = torch.float32

        def cpu(self):
            raise torch.OutOfMemoryError(
                "CUDA out of memory while copying the coalesced rows")

    req = executor._Request(mf.stage_inputs(x), 3, None,
                            resilience.DEFAULT_INFERENCE_POLICY)
    req.future.set_result((_LateBoom(), None))
    with HealthMonitor() as mon:
        out = svc._await(state, req, time.monotonic())
    np.testing.assert_array_equal(out, _apply(mf, x))
    assert mon.count(health.OOM_RECHUNK) == 1


def test_mixed_shape_window_launches_per_shape_group():
    shapes = []

    def apply_fn(vs, x):
        shapes.append(tuple(x.shape))
        time.sleep(0.05)
        return torch.tanh(x.reshape(x.shape[0], -1).sum(1, keepdim=True)
                          * vs)

    mf = ModelFunction(apply_fn, torch.tensor([0.5, -1.0, 2.0]),
                       TensorSpec((None, None)), name="anyshape")
    EngineConfig.coalesce_window_ms = 150.0
    rng = np.random.default_rng(0)
    inputs = ([rng.normal(size=(3, 4)).astype(np.float32)
               for _ in range(3)]
              + [rng.normal(size=(3, 7)).astype(np.float32)
                 for _ in range(3)])
    expected = [_apply(mf, x) for x in inputs]
    results, errors = _run_concurrent(mf, inputs)
    assert errors == [None] * 6, errors
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Task tokens and hand-back
# ---------------------------------------------------------------------------


def test_task_token_sequence_and_reset():
    from sparkdl_tpu_torch.core.executor import (
        current_task_token, reset_call_sequence,
    )

    reset_call_sequence()  # outside any scope: a no-op
    assert current_task_token() is None
    with task_scope(("t", 1)):
        assert current_task_token() == ("t", 1, 0)
        assert current_task_token() == ("t", 1, 1)
        with task_scope(("t", 2)):
            assert current_task_token() == ("t", 2, 0)
        assert current_task_token() == ("t", 1, 2)
        reset_call_sequence()  # the next retry-loop attempt
        assert current_task_token() == ("t", 1, 0)
    with task_scope(("t", 1)):  # a hedge attempt restarts at 0
        assert current_task_token() == ("t", 1, 0)
    assert current_task_token() is None


def test_hedge_reexecutes_independently_once_sibling_is_in_flight():
    mf = _model(sleep_s=0.2)
    EngineConfig.coalesce_window_ms = 100.0
    x = _rows(3, seed=4)
    token = ("task", 99, 0)
    results, errors = {}, []

    def attempt(name):
        try:
            with task_scope(token):
                results[name] = executor.execute(mf, x, batch_size=32)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    with Telemetry() as tel:
        t_primary = _start(attempt, "primary")
        time.sleep(0.08)
        t_hedge = _start(attempt, "hedge")
        _join(t_primary, t_hedge)
    assert not errors
    for name in ("primary", "hedge"):
        np.testing.assert_array_equal(results[name], _apply(mf, x))
    snap = tel.metrics.snapshot()
    assert snap["counters"].get(telemetry.M_COALESCE_DEDUP, 0) == 0
    assert snap["histograms"][telemetry.M_COALESCE_ROWS]["sum"] == 3


def test_solo_drained_window_replays_on_the_requester_thread():
    mf = _model(sleep_s=0.2)
    EngineConfig.coalesce_window_ms = 30.0
    apply_threads, orig = _record_apply_threads(mf)
    outcome = {}
    x_busy, x_queued = _rows(2, seed=0), _rows(3, seed=1)

    def run(name, x):
        outcome[name] = executor.execute(mf, x, batch_size=32)

    t_busy = _start(run, "busy", x_busy, name="requester-busy")
    time.sleep(0.05)
    t_q = _start(run, "queued", x_queued, name="requester-queued")
    _join(t_busy, t_q)
    assert set(apply_threads) == {"requester-busy", "requester-queued"}
    for name, x in (("busy", x_busy), ("queued", x_queued)):
        np.testing.assert_array_equal(outcome[name],
                                      orig(x, batch_size=32, device="cpu"))


# ---------------------------------------------------------------------------
# Shutdown: no leaked futures
# ---------------------------------------------------------------------------


def test_shutdown_midwindow_every_request_completes_or_raises():
    mf = _model(sleep_s=0.4)
    EngineConfig.coalesce_window_ms = 30_000.0  # park the queued request
    x_busy, x_queued = _rows(2, seed=0), _rows(3, seed=1)
    outcome = {}

    def busy():
        outcome["busy"] = executor.execute(mf, x_busy, batch_size=32)

    def queued():
        try:
            outcome["queued"] = executor.execute(mf, x_queued,
                                                 batch_size=32)
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome["queued_error"] = e

    t_busy = _start(busy)
    time.sleep(0.1)
    t_q = _start(queued)
    time.sleep(0.1)
    executor.shutdown()
    _join(t_q, t_busy)
    np.testing.assert_array_equal(outcome["busy"], _apply(mf, x_busy))
    assert isinstance(outcome.get("queued_error"), ExecutorShutdown)
    assert "queued" not in outcome


def test_shutdown_racing_concurrent_submits_never_hangs_or_leaks():
    mf = _model(sleep_s=0.02)
    EngineConfig.coalesce_window_ms = 20.0
    x = _rows(3, seed=1)
    expected = _apply(mf, x)
    bad, done = [], []

    def submitter():
        while True:
            try:
                np.testing.assert_array_equal(
                    executor.execute(mf, x, batch_size=32), expected)
            except ExecutorShutdown:
                done.append(1)
                return
            except BaseException as e:  # noqa: BLE001 - asserted below
                bad.append(e)
                return

    threads = [_start(submitter) for _ in range(6)]
    time.sleep(0.15)
    executor.shutdown()
    executor.shutdown()  # a racing double shutdown stays a no-op
    _join(*threads)
    assert not bad, bad
    assert len(done) == 6
    with pytest.raises(ExecutorShutdown):
        executor.service().submit(mf, x, len(x), 32, CPU,
                                  resilience.DEFAULT_INFERENCE_POLICY,
                                  None, 32, 0)


def test_double_shutdown_and_double_reset_are_noops():
    mf = _model()
    executor.execute(mf, _rows(2), batch_size=16)
    executor.shutdown()
    executor.shutdown()
    svc = executor.reset()
    assert executor.service() is svc
    svc2 = executor.reset()
    assert executor.service() is svc2
    np.testing.assert_array_equal(
        executor.execute(mf, _rows(2), batch_size=16),
        _apply(mf, _rows(2), 16))
    assert executor.status()["closed"] is False


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def test_shed_mode_fails_fast_and_accounts_exactly():
    mf = _model(sleep_s=0.3)
    EngineConfig.coalesce_window_ms = 30_000.0
    EngineConfig.executor_max_queued_requests = 1
    EngineConfig.executor_overload_mode = "shed"
    outcome = {}

    def run(name, n, seed):
        try:
            outcome[name] = executor.execute(mf, _rows(n, seed=seed),
                                             batch_size=32)
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome[name + "_error"] = e

    with HealthMonitor() as mon, Telemetry() as tel:
        t_busy = _start(run, "busy", 2, 0)
        time.sleep(0.1)
        t_a = _start(run, "a", 3, 1)
        time.sleep(0.05)
        t_b = _start(run, "b", 3, 1)
        _join(t_b)
        err = outcome.get("b_error")
        assert isinstance(err, ExecutorOverloaded)
        assert resilience.classify(err) == resilience.RETRYABLE
        executor.shutdown()
        _join(t_a, t_busy)
    assert isinstance(outcome.get("a_error"), ExecutorShutdown)
    assert mon.count(health.EXECUTOR_SHED) == 1
    snap = tel.metrics.snapshot()
    assert snap["counters"]["sparkdl.health." + health.EXECUTOR_SHED] == 1
    assert snap["gauges"][telemetry.M_EXECUTOR_SHED_RATE] == \
        pytest.approx(1 / 3)
    assert telemetry.M_EXECUTOR_QUEUE_DEPTH in snap["gauges"]


def test_queued_rows_bound_sheds_but_empty_queue_always_admits():
    mf = _model(sleep_s=0.25)
    EngineConfig.coalesce_window_ms = 30_000.0
    EngineConfig.executor_max_queued_rows = 4
    EngineConfig.executor_overload_mode = "shed"
    outcome = {}

    def run(name, n, seed):
        try:
            outcome[name] = executor.execute(mf, _rows(n, seed=seed),
                                             batch_size=32)
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome[name + "_error"] = e

    t_busy = _start(run, "busy", 2, 0)
    time.sleep(0.08)
    t_big = _start(run, "big", 6, 1)  # over the bound, queue empty: admitted
    time.sleep(0.05)
    t_over = _start(run, "over", 2, 2)
    _join(t_over)
    assert isinstance(outcome.get("over_error"), ExecutorOverloaded)
    executor.shutdown()
    _join(t_big, t_busy)
    assert isinstance(outcome.get("big_error"), ExecutorShutdown)


def test_block_mode_waits_for_room_and_completes():
    mf = _model(sleep_s=0.1)
    EngineConfig.coalesce_window_ms = 50.0
    EngineConfig.executor_max_queued_requests = 1
    assert EngineConfig.executor_overload_mode == "block"
    inputs = [_rows(3, seed=i) for i in range(4)]
    expected = [_apply(mf, x) for x in inputs]
    results, errors = _run_concurrent(mf, inputs)
    assert errors == [None] * 4
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)


def test_block_mode_backpressure_is_bounded_by_the_deadline():
    mf = _model(sleep_s=0.4)
    EngineConfig.coalesce_window_ms = 30_000.0
    EngineConfig.executor_max_queued_requests = 1
    outcome = {}

    def run(name, seed, deadline=None):
        try:
            outcome[name] = executor.execute(mf, _rows(2, seed=seed),
                                             batch_size=32,
                                             deadline=deadline)
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome[name + "_error"] = e

    with HealthMonitor() as mon:
        t_busy = _start(run, "busy", 0)
        time.sleep(0.1)
        t_a = _start(run, "a", 1)
        time.sleep(0.05)
        t0 = time.monotonic()
        t_b = _start(run, "b", 2, Deadline(0.25))
        _join(t_b)
        waited = time.monotonic() - t0
        assert isinstance(outcome.get("b_error"),
                          resilience.DeadlineExceeded)
        assert 0.15 < waited < 2.0
        executor.shutdown()
        _join(t_a, t_busy)
    assert mon.count(health.EXECUTOR_DEADLINE_SHED) == 1


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def test_expired_request_is_dropped_at_drain_time_without_a_launch():
    mf = _model(sleep_s=0.2)
    EngineConfig.coalesce_window_ms = 400.0
    apply_log, _ = _record_apply_threads(mf)
    outcome = {}

    def busy():
        outcome["busy"] = executor.execute(mf, _rows(2, seed=0),
                                           batch_size=32)

    def doomed():
        t0 = time.monotonic()
        try:
            outcome["doomed"] = executor.execute(
                mf, _rows(3, seed=1), batch_size=32,
                deadline=Deadline(0.08))
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome["doomed_error"] = e
        outcome["doomed_s"] = time.monotonic() - t0

    with HealthMonitor() as mon:
        t_busy = _start(busy)
        time.sleep(0.05)
        t_d = _start(doomed)
        _join(t_d, t_busy)
    assert isinstance(outcome.get("doomed_error"),
                      resilience.DeadlineExceeded)
    assert outcome["doomed_s"] < 0.3, outcome["doomed_s"]
    assert mon.count(health.EXECUTOR_DEADLINE_SHED) == 1
    assert len(apply_log) == 1


def test_already_expired_deadline_is_rejected_before_queueing():
    mf = _model(sleep_s=0.1)
    EngineConfig.coalesce_window_ms = 100.0
    dead = Deadline(0.0)
    t_busy = _start(lambda: executor.execute(mf, _rows(2, seed=0),
                                             batch_size=32))
    time.sleep(0.04)
    with HealthMonitor() as mon:
        with pytest.raises(resilience.DeadlineExceeded):
            executor.execute(mf, _rows(3, seed=1), batch_size=32,
                             deadline=dead)
    _join(t_busy)
    assert mon.count(health.EXECUTOR_DEADLINE_SHED) == 1


def test_run_partition_task_threads_its_deadline_into_the_executor():
    seen = {}

    def op(batch):
        seen["deadline"] = executor.current_deadline()
        return batch

    fast = RetryPolicy(max_retries=0, base_delay_s=0.0, jitter=0.0)
    run_partition_task(0, "x", [op], policy=fast, deadline_s=5.0)
    assert seen["deadline"].timeout_s == 5.0
    run_partition_task(0, "x", [op], policy=fast, deadline_s=None)
    assert seen["deadline"] is None
    assert executor.current_deadline() is None


def test_hedge_dedup_adopts_the_latest_deadline():
    mf = _model(sleep_s=0.15)
    EngineConfig.coalesce_window_ms = 300.0
    token = ("hedged-task", 7)
    x = _rows(3, seed=1)
    outcome = {}

    def busy():
        outcome["busy"] = executor.execute(mf, _rows(2, seed=0),
                                           batch_size=32)

    def attempt(name, budget):
        with task_scope(token):
            try:
                outcome[name] = executor.execute(
                    mf, x, batch_size=32, deadline=Deadline(budget))
            except BaseException as e:  # noqa: BLE001 - asserted below
                outcome[name + "_error"] = e

    t_busy = _start(busy)
    time.sleep(0.05)
    t_p = _start(attempt, "primary", 0.08)
    time.sleep(0.02)
    t_h = _start(attempt, "hedge", 10.0)
    _join(t_busy, t_p, t_h)
    expected = _apply(mf, x)
    assert "primary_error" not in outcome and "hedge_error" not in outcome
    np.testing.assert_array_equal(outcome["hedge"], expected)
    np.testing.assert_array_equal(outcome["primary"], expected)


# ---------------------------------------------------------------------------
# Priority lanes and tenants
# ---------------------------------------------------------------------------


def test_interactive_lane_drains_before_earlier_bulk_requests():
    mf = _model(sleep_s=0.25)
    EngineConfig.coalesce_window_ms = 400.0
    EngineConfig.coalesce_max_rows = 7
    apply_log, orig = _record_apply_threads(mf)
    inputs = {"bulk1": _rows(3, seed=1), "bulk2": _rows(3, seed=2),
              "inter": _rows(3, seed=3)}
    expected = {k: orig(v, batch_size=32, device="cpu")
                for k, v in inputs.items()}
    outcome, errors = {}, []

    def run(name, priority):
        try:
            outcome[name] = executor.execute(mf, inputs[name],
                                             batch_size=32,
                                             priority=priority)
        except BaseException as e:  # noqa: BLE001
            errors.append((name, e))

    t_busy = _start(lambda: executor.execute(mf, _rows(2, seed=0),
                                             batch_size=32),
                    name="requester-busy")
    time.sleep(0.08)
    threads = []
    for name, prio in (("bulk1", "bulk"), ("bulk2", "bulk"),
                       ("inter", "interactive")):
        threads.append(_start(run, name, prio, name=f"requester-{name}"))
        time.sleep(0.04)
    _join(*threads, t_busy)
    assert not errors, errors
    for name, want in expected.items():
        np.testing.assert_array_equal(outcome[name], want)
    assert set(apply_log) == {"requester-busy", "requester-bulk2"}


def test_shed_mode_interactive_displaces_newest_queued_bulk():
    mf = _model(sleep_s=0.3)
    EngineConfig.coalesce_window_ms = 30_000.0
    EngineConfig.executor_max_queued_requests = 1
    EngineConfig.executor_overload_mode = "shed"
    outcome = {}

    def run(name, priority, seed):
        try:
            outcome[name] = executor.execute(mf, _rows(3, seed=seed),
                                             batch_size=32,
                                             priority=priority)
        except BaseException as e:  # noqa: BLE001 - asserted below
            outcome[name + "_error"] = e

    with HealthMonitor() as mon:
        t_busy = _start(run, "busy", "bulk", 0)
        time.sleep(0.1)
        t_bulk = _start(run, "bulk", "bulk", 1)
        time.sleep(0.05)
        t_inter = _start(run, "inter", "interactive", 2)
        _join(t_bulk)
        err = outcome.get("bulk_error")
        assert isinstance(err, ExecutorOverloaded) and "displaced" in str(err)
        executor.shutdown()
        _join(t_inter, t_busy)
    assert isinstance(outcome.get("inter_error"), ExecutorShutdown)
    sheds = mon.events(health.EXECUTOR_SHED)
    assert len(sheds) == 1 and sheds[0]["reason"] == "displaced"


def test_tenant_drr_releases_by_weight_and_records_throttling():
    """Two tenants in one lane behind a busy launch, weights heavy 2,
    light 1, a cap of 10 rows, three 4-row requests (light, light, then
    heavy): FIFO would release both light ones; deficit round robin
    releases the heavy one and one light one, and the second light one
    is throttled into the next round, where it runs alone on its own
    thread."""
    mf = _model(sleep_s=0.2)
    EngineConfig.coalesce_window_ms = 300.0
    EngineConfig.coalesce_max_rows = 10
    EngineConfig.executor_tenant_weights = {"heavy": 2}
    apply_log, orig = _record_apply_threads(mf)
    order = [("light0", "light"), ("light1", "light"), ("heavy2", "heavy")]
    inputs = {name: _rows(4, seed=i + 1)
              for i, (name, _) in enumerate(order)}
    outcome = {}

    def run(name, tenant):
        with executor.tenant_scope(tenant):
            outcome[name] = executor.execute(mf, inputs[name],
                                             batch_size=32)

    with HealthMonitor() as mon, Telemetry() as tel:
        t_busy = _start(lambda: executor.execute(mf, _rows(2, seed=0),
                                                 batch_size=32),
                        name="requester-busy")
        time.sleep(0.05)
        threads = []
        for name, tenant in order:
            threads.append(_start(run, name, tenant,
                                  name=f"requester-{name}"))
            time.sleep(0.02)
        _join(*threads, t_busy)
    assert set(apply_log) == {"requester-busy", "requester-light1"}
    for name, x in inputs.items():
        np.testing.assert_array_equal(outcome[name],
                                      orig(x, batch_size=32, device="cpu"))
    assert [e["tenant"] for e in mon.events(health.TENANT_THROTTLED)] == \
        ["light"]
    assert telemetry.tenant_queue_wait_metric("heavy") in _histograms(tel)


def test_invalid_priority_raises_instead_of_hanging():
    with pytest.raises(ValueError, match="priority"):
        executor.execute(_model(), _rows(2), batch_size=16,
                         priority="INTERACTIVE")


# ---------------------------------------------------------------------------
# Per-model circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_trips_fails_fast_probes_and_recovers():
    fail = [True]
    mf = _model(name="breaker_model", fail_flag=fail)
    EngineConfig.executor_breaker_threshold = 2
    EngineConfig.executor_breaker_cooldown_s = 0.15
    x = _rows(3, seed=1)
    calls, orig = _record_apply_threads(mf)
    with HealthMonitor() as mon:
        for _ in range(2):
            with pytest.raises(Exception) as ei:
                executor.execute(mf, x, batch_size=32)
            assert resilience.classify(ei.value) == resilience.FATAL
        assert mon.count(health.BREAKER_OPEN) == 1
        with pytest.raises(ExecutorCircuitOpen) as ei:
            executor.execute(mf, x, batch_size=32)
        assert resilience.classify(ei.value) == resilience.RETRYABLE
        assert len(calls) == 2
        fail[0] = False
        time.sleep(0.2)
        want = orig(x, batch_size=32, device="cpu")
        np.testing.assert_array_equal(
            executor.execute(mf, x, batch_size=32), want)
        assert mon.count(health.BREAKER_PROBE) == 1
        assert mon.count(health.BREAKER_CLOSED) == 1
        np.testing.assert_array_equal(
            executor.execute(mf, x, batch_size=32), want)
    assert mon.count(health.BREAKER_OPEN) == 1


def test_breaker_failed_probe_reopens():
    fail = [True]
    mf = _model(name="breaker_reopen", fail_flag=fail)
    EngineConfig.executor_breaker_threshold = 1
    EngineConfig.executor_breaker_cooldown_s = 0.1
    x = _rows(2, seed=1)
    with HealthMonitor() as mon:
        with pytest.raises(Exception):
            executor.execute(mf, x, batch_size=32)
        time.sleep(0.15)
        with pytest.raises(Exception) as ei:
            executor.execute(mf, x, batch_size=32)
        assert not isinstance(ei.value, ExecutorCircuitOpen)
        assert mon.count(health.BREAKER_PROBE) == 1
        assert mon.count(health.BREAKER_OPEN) == 2
        with pytest.raises(ExecutorCircuitOpen):
            executor.execute(mf, x, batch_size=32)
    assert mon.count(health.BREAKER_CLOSED) == 0


def test_probe_dying_in_queue_releases_the_probe_slot():
    def hook(x):
        if x[0, 0] >= 900.0:
            time.sleep(0.4)  # a launch held in flight
        if x[0, 0] <= -900.0:
            raise ValueError("INVALID_ARGUMENT: poisoned input")

    mf = _model(name="probe_wedge", hook=hook)
    EngineConfig.executor_breaker_threshold = 1
    EngineConfig.executor_breaker_cooldown_s = 0.05
    EngineConfig.coalesce_window_ms = 150.0
    ok = _rows(2, seed=1)
    bad, slow = ok.copy(), ok.copy()
    bad[0, 0], slow[0, 0] = -999.0, 999.0
    with HealthMonitor() as mon:
        with pytest.raises(Exception) as ei:
            executor.execute(mf, bad, batch_size=32)
        assert resilience.classify(ei.value) == resilience.FATAL
        time.sleep(0.1)
        EngineConfig.executor_breaker_threshold = 0  # this submit opts out
        busy = _start(lambda: executor.execute(mf, slow, batch_size=32))
        time.sleep(0.1)
        EngineConfig.executor_breaker_threshold = 1
        with pytest.raises(resilience.DeadlineExceeded):
            executor.execute(mf, ok, batch_size=32,
                             deadline=Deadline(0.03))
        assert mon.count(health.BREAKER_PROBE) == 1
        out = executor.execute(mf, ok, batch_size=32)
        np.testing.assert_array_equal(out, _apply(mf, ok))
        _join(busy)
    assert mon.count(health.BREAKER_PROBE) == 2
    assert mon.count(health.BREAKER_CLOSED) == 1
    assert mon.count(health.EXECUTOR_DEADLINE_SHED) == 1


def test_stale_nonprobe_outcome_does_not_decide_half_open_probe():
    mf = _model(name="stale_halfopen")
    EngineConfig.executor_breaker_threshold = 1
    executor.execute(mf, _rows(2), batch_size=16)  # prime the state
    svc = executor.service()
    state = next(iter(svc._states.values()))
    with state.cond:
        state.breaker_state = "half_open"
        state.breaker_probe_inflight = True
    with HealthMonitor() as mon:
        svc._breaker_note(state, None)
        svc._breaker_note(state, RuntimeError("stale launch failure"))
        assert state.breaker_state == "half_open"
        assert state.breaker_probe_inflight
        svc._breaker_note(state, None, is_probe=True)
        assert state.breaker_state == "closed"
        assert not state.breaker_probe_inflight
    assert mon.count(health.BREAKER_CLOSED) == 1
    assert mon.count(health.BREAKER_OPEN) == 0


def test_breaker_disabled_by_default_never_records_events():
    mf = _model(name="no_breaker", fail_flag=[True])
    assert EngineConfig.executor_breaker_threshold == 0
    with HealthMonitor() as mon:
        for _ in range(3):
            with pytest.raises(Exception) as ei:
                executor.execute(mf, _rows(2, seed=1), batch_size=32)
            assert not isinstance(ei.value, ExecutorCircuitOpen)
    assert mon.count(health.BREAKER_OPEN) == 0


# ---------------------------------------------------------------------------
# EngineConfig read-time validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob,value", [
    ("max_task_retries", -1),
    ("task_retry_delay_s", -0.5),
    ("task_timeout_s", -3.0),
    ("task_timeout_s", 0.0),
    ("speculation_quantile", 1.5),
    ("speculation_quantile", -0.1),
    ("speculation_multiplier", 0.0),
    ("speculation_min_runtime_s", -1.0),
    ("quarantine_max_fatal", 0),
    ("coalesce_window_ms", -5.0),
    ("coalesce_max_rows", 0),
    ("executor_max_queued_requests", 0),
    ("executor_max_queued_requests", -2),
    ("executor_max_queued_rows", 0),
    ("executor_overload_mode", "drop"),
    ("executor_default_priority", "realtime"),
    ("executor_breaker_threshold", -1),
    ("executor_breaker_window_s", 0.0),
    ("executor_breaker_cooldown_s", -1.0),
    ("executor_idle_retire_s", 0.0),
    ("executor_tenant_weights", {"a": 0}),
    ("executor_tenant_weights", ["a"]),
    ("executor_default_tenant", ""),
    ("inference_precision", "float16"),
    ("bucket_ladder", "adaptive"),
    ("max_workers", 0),
])
def test_engine_config_validation_rejects(knob, value):
    setattr(EngineConfig, knob, value)
    with pytest.raises(ValueError, match=knob):
        EngineConfig.validate()


def test_bad_knobs_fail_at_the_read_site_not_downstream():
    from sparkdl_tpu_torch.engine.dataframe import DataFrame

    EngineConfig.executor_max_queued_requests = 0
    with pytest.raises(ValueError, match="executor_max_queued_requests"):
        executor.execute(_model(), _rows(2), batch_size=16)
    EngineConfig.executor_max_queued_requests = None
    EngineConfig.task_timeout_s = -1.0
    df = DataFrame.fromColumns({"x": np.arange(4)}, numPartitions=2)
    with pytest.raises(ValueError, match="task_timeout_s"):
        df.withColumnBatch("y", lambda b: b.column("x")).collect()


def test_defaults_validate_cleanly_stay_unbounded_and_snapshot():
    EngineConfig.validate()
    assert EngineConfig.executor_max_queued_requests is None
    assert EngineConfig.executor_max_queued_rows is None
    assert EngineConfig.executor_overload_mode == "block"
    assert EngineConfig.executor_default_priority == "bulk"
    assert EngineConfig.executor_breaker_threshold == 0
    assert EngineConfig.coalesce is True
    snap = EngineConfig.snapshot()
    for knob in ("coalesce", "coalesce_window_ms", "max_workers",
                 "task_timeout_s", "executor_tenant_weights",
                 "speculation", "quarantine"):
        assert knob in snap


def test_transformer_priority_param_validates_and_rides_to_execute(
        monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import DataFrame
    from sparkdl_tpu_torch.image import imageIO
    from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer

    with pytest.raises(TypeError, match="priority"):
        TorchImageTransformer(inputCol="x", outputCol="y",
                              priority="realtime")
    mf = ModelFunction(lambda vs, x: x.reshape(x.shape[0], -1).mean(1),
                       None, TensorSpec((None, 4, 4, 3)), name="mean")
    t = TorchImageTransformer(inputCol="image", outputCol="y",
                              modelFunction=mf, batchSize=16,
                              priority="interactive")
    assert t.getPriority() == "interactive"
    seen = []
    orig_execute = executor.execute

    def spying_execute(*args, **kwargs):
        seen.append(kwargs.get("priority"))
        return orig_execute(*args, **kwargs)

    monkeypatch.setattr(executor, "execute", spying_execute)
    imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(5)]
    df = DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(imgs, ["o"] * 5)},
        numPartitions=2)
    assert len(t.transform(df).collect()) == 5
    assert seen == ["interactive", "interactive"]
    assert TorchImageTransformer(inputCol="a", outputCol="b"
                                 ).getPriority() is None
