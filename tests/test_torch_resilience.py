"""The port's resilience taxonomy against the JAX package's, and the
classified retry and OOM re-chunk of ``run_batched``/``apply_batch``.

``classify`` must give the reference's answer on every exception of the
reference's own table (each package raising its own exception types),
plus the CUDA runtime's failures, which only the port sees.
``RetryPolicy.delay`` must give the reference's delays bit for bit for
the same seed. The batching cases mirror the reference's
``tests/core/test_resilience.py`` on the CPU, where the port's
``run_batched`` runs a ``(chunk, n_valid)`` callable: every re-chunked
or retried output is bit-identical and in order.
"""

import random
import threading

import numpy as np
import pytest
import torch

from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import resilience as jax_res
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu_torch.core import batching, health, resilience
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.core.resilience import (
    FATAL, OOM, RETRYABLE, Deadline, DeadlineExceeded, DeviceOOM, Fault,
    FaultInjector, Preemption, RetryPolicy, TransferStall, classify,
)

CPU = torch.device("cpu")

# (label, factory(resilience module) -> exception): each package builds
# the exception from its own types
TABLE = [
    ("value", lambda r: ValueError("shape mismatch")),
    ("type", lambda r: TypeError("dtype")),
    ("key", lambda r: KeyError("col")),
    ("index", lambda r: IndexError("row 9")),
    ("not_impl", lambda r: NotImplementedError("later")),
    ("deadline", lambda r: r.DeadlineExceeded("too slow")),
    ("invalid_arg", lambda r: RuntimeError("INVALID_ARGUMENT: bad program")),
    ("precondition", lambda r: RuntimeError("FAILED_PRECONDITION: state")),
    ("device_oom", lambda r: r.DeviceOOM()),
    ("resource_exhausted", lambda r: RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory allocating")),
    ("resource_prose", lambda r: RuntimeError("Resource exhausted: HBM")),
    ("preemption", lambda r: r.Preemption()),
    ("transfer_stall", lambda r: r.TransferStall()),
    ("worker_fault", lambda r: r.WorkerFault()),
    ("overloaded", lambda r: r.ExecutorOverloaded("queue full")),
    ("circuit_open", lambda r: r.ExecutorCircuitOpen("open")),
    ("decode_lost", lambda r: r.DecodeWorkerLost("gone")),
    ("cluster_lost", lambda r: r.ClusterWorkerLost("gone")),
    ("draining", lambda r: r.WorkerDraining("all candidates draining")),
    ("drain_timeout", lambda r: r.DrainTimeout("exceeded the drain grace")),
    ("replica_lost", lambda r: r.ServingReplicaLost("gone")),
    ("stale_writer", lambda r: r.StaleCheckpointWriter("fenced")),
    ("unavailable", lambda r: RuntimeError("UNAVAILABLE: socket closed")),
    ("unknown", lambda r: RuntimeError("something unprecedented")),
    ("conn_reset", lambda r: OSError("connection reset")),
    ("fatal_wrapped_transient", lambda r: ValueError(
        "UNAVAILABLE: socket closed mid-collective")),
    ("oom_word", lambda r: RuntimeError("OOM while allocating 2.1GiB")),
    ("oom_prose", lambda r: RuntimeError(
        "Out of memory while trying to allocate 8589934592 bytes")),
    ("bloom_runtime", lambda r: RuntimeError("BLOOM shard failed to load")),
    ("bloom_value", lambda r: ValueError("BLOOM config invalid")),
    ("injected_behavioral", lambda r: r.InjectedFault("injected x")),
]


class _Kinded(RuntimeError):
    failure_kind = "fatal"


@pytest.mark.parametrize("label,make", TABLE + [
    ("failure_kind", lambda r: _Kinded("UNAVAILABLE: but recorded fatal")),
], ids=[t[0] for t in TABLE] + ["failure_kind"])
def test_classify_matches_reference(label, make):
    assert classify(make(resilience)) == jax_res.classify(make(jax_res))


@pytest.mark.parametrize("err,kind", [
    (torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 32.00 TiB. GPU 0 has a "
        "total capacity of 79.19 GiB"), OOM),
    (RuntimeError("CUDA error: out of memory"), OOM),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     FATAL),
    (RuntimeError("CUDA error: device-side assert triggered"), FATAL),
    (RuntimeError("CUDA error: unspecified launch failure"), FATAL),
    (RuntimeError("CUDA error: misaligned address"), FATAL),
    (RuntimeError("sep2d kernel launch failed: CUDA error 1"), RETRYABLE),
], ids=["torch_oom", "cuda_oom", "illegal_access", "device_assert",
        "launch_failure", "misaligned", "launch_error_code"])
def test_classify_cuda_failures(err, kind):
    assert classify(err) == kind


class _SeedByHash(random.Random):
    """``random.Random`` as Python 3.10 seeded it: an object that is not
    an int, float, str or bytes seeds by its hash cast to unsigned. The
    reference's ``RetryPolicy.delay`` seeds with a tuple, which Python
    3.11 refuses (TypeError), so its delays are read under this seeding,
    the one its code was written for."""

    def __init__(self, x=None):
        if not isinstance(x, (type(None), int, float, str, bytes,
                              bytearray)):
            x = hash(x) & 0xFFFFFFFFFFFFFFFF
        super().__init__(x)


def test_reference_jitter_needs_a_tuple_seed():
    """The reason for the seeding shim below: under this Python the
    reference's jittered delay raises, the port's does not."""
    with pytest.raises(TypeError, match="seed"):
        jax_res.RetryPolicy(seed=7).delay(1)
    assert RetryPolicy(seed=7).delay(1) > 0


@pytest.mark.parametrize("kw", [
    {}, {"seed": 7}, {"seed": 8, "jitter": 0.4, "multiplier": 3.0},
    {"base_delay_s": 0.25, "max_delay_s": 2.0, "jitter": 0.0},
    {"base_delay_s": 0.2, "max_delay_s": 5.0, "max_retries": 2},
], ids=["default", "seed7", "seed8", "no_jitter", "inference"])
def test_retry_delays_equal_reference(kw, monkeypatch):
    monkeypatch.setattr(random, "Random", _SeedByHash)
    ours, ref = RetryPolicy(**kw), jax_res.RetryPolicy(**kw)
    assert [ours.delay(a) for a in range(1, 11)] == \
        [ref.delay(a) for a in range(1, 11)]
    assert resilience.DEFAULT_INFERENCE_POLICY == RetryPolicy(
        **{f: getattr(jax_res.DEFAULT_INFERENCE_POLICY, f)
           for f in ("max_retries", "base_delay_s", "max_delay_s",
                     "multiplier", "jitter", "seed")})
    with pytest.raises(ValueError):
        ours.delay(0)


def test_injection_points_are_the_reference_registry():
    assert set(resilience.INJECTION_POINTS) == set(jax_res.INJECTION_POINTS)


@pytest.mark.parametrize("errors,result,calls,slept", [
    ([TransferStall(), Preemption()], "ok", 3, [0.5, 1.0]),
    ([ValueError("bad shape")], ValueError, 1, []),
    ([DeviceOOM()], DeviceOOM, 1, []),
    ([Preemption()] * 5, Preemption, 4, [0.5, 1.0, 2.0]),
], ids=["transient_retried", "fatal_once", "oom_once", "exhausted"])
def test_retry_policy_execute(errors, result, calls, slept):
    seen, sleeps = [], []

    def fn():
        seen.append(1)
        if len(seen) <= len(errors):
            raise errors[len(seen) - 1]
        return "ok"

    policy = RetryPolicy(max_retries=3, base_delay_s=0.5, jitter=0.0)
    if isinstance(result, type):
        with pytest.raises(result):
            policy.execute(fn, sleep=sleeps.append)
    else:
        assert policy.execute(fn, sleep=sleeps.append) == result
    assert len(seen) == calls and sleeps == slept


def test_deadline_bounds_retries():
    clock = [0.0]

    def always():
        clock[0] += 10.0
        raise TransferStall()

    d = Deadline(15.0, clock=lambda: clock[0])
    with pytest.raises(DeadlineExceeded):
        RetryPolicy(max_retries=10, base_delay_s=0.0).execute(
            always, deadline=d, sleep=lambda s: None)
    assert Deadline(None).remaining() == float("inf")


def test_injector_arming_after_when_nesting_and_threads():
    with pytest.raises(ValueError, match="Unknown injection point"):
        FaultInjector.seeded(0, not_a_point=1)
    with FaultInjector.seeded(0, device_oom=2) as inj:
        for _ in range(2):
            with pytest.raises(DeviceOOM):
                resilience.inject("device_oom")
        resilience.inject("device_oom")
        assert inj.fired["device_oom"] == 2
    with FaultInjector.seeded(0, transfer_stall=Fault(
            after=1, when=lambda ctx: ctx.get("rows") == 8)) as inj:
        resilience.inject("transfer_stall", rows=8)
        resilience.inject("transfer_stall", rows=4)
        with pytest.raises(TransferStall):
            resilience.inject("transfer_stall", rows=8)
    with FaultInjector.seeded(0, device_oom=5):
        with FaultInjector.seeded(0, preemption=5):
            resilience.inject("device_oom")  # inner masks outer
        hit = []

        def worker():
            try:
                resilience.inject("device_oom")
            except DeviceOOM:
                hit.append(True)

        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
        assert hit == [True]
    assert resilience.active_injector() is None


# -- run_batched: classified retry and OOM re-chunk --------------------------

FAST = RetryPolicy(max_retries=2, base_delay_s=0.0)


def _doubler(calls):
    def fn(chunk, n_valid):
        calls.append(chunk.shape[0])
        return (chunk * 2.0)[:n_valid]
    return fn


def test_run_batched_oom_rechunks_at_halved_bucket_identical_output():
    calls = []
    arr = np.arange(40, dtype=np.float32).reshape(20, 2)
    baseline = batching.run_batched(_doubler(calls), arr, 8, CPU)
    calls.clear()
    with FaultInjector.seeded(0, device_oom=Fault(
            times=-1, when=lambda ctx: ctx["rows"] >= 8)) as inj, \
            health.HealthMonitor() as mon:
        out = batching.run_batched(_doubler(calls), arr, 8, CPU,
                                   retry_policy=FAST)
    np.testing.assert_array_equal(out, baseline)
    assert inj.fired["device_oom"] == 3  # three chunks of bucket 8
    assert calls and max(calls) <= 4
    assert mon.report()["counters"]["oom_rechunk"] == 3


def test_run_batched_transient_error_retries_same_chunk():
    calls = []
    arr = np.arange(10, dtype=np.float32).reshape(10, 1)
    with FaultInjector.seeded(0, transfer_stall=1) as inj, \
            health.HealthMonitor() as mon:
        out = batching.run_batched(_doubler(calls), arr, 4, CPU,
                                   retry_policy=FAST)
    np.testing.assert_array_equal(out, arr * 2)
    assert inj.fired["transfer_stall"] == 1
    assert calls == [4, 4, 4]  # the stall fired before the first call
    assert mon.report()["counters"] == {"chunk_retry": 1}


def test_run_batched_fatal_error_propagates_unretried():
    calls = []

    def fn(chunk, n_valid):
        calls.append(1)
        raise ValueError("bad dtype in program")

    with pytest.raises(ValueError, match="bad dtype"):
        batching.run_batched(fn, np.zeros((4, 1), np.float32), 4, CPU,
                             retry_policy=FAST)
    assert len(calls) == 1


def test_run_batched_oom_at_bucket_one_propagates():
    """One row in a bucket of 4 re-chunks at 2, then 1, then propagates."""
    calls = []
    with FaultInjector.seeded(0, device_oom=Fault(times=-1)) as inj:
        with pytest.raises(DeviceOOM):
            batching.run_batched(_doubler(calls),
                                 np.zeros((1, 1), np.float32), 4, CPU,
                                 retry_policy=FAST)
    assert inj.fired["device_oom"] == 3 and calls == []


# -- apply_batch, against the reference ---------------------------------------

W = np.arange(6.0, dtype=np.float32).reshape(3, 2)


def _linear_models():
    ours = ModelFunction.fromFunction(
        lambda vs, x: x @ vs, torch.from_numpy(W), TensorSpec((None, 3)))
    ref = JaxModelFunction.fromFunction(
        lambda vs, x: x @ vs, W, JaxTensorSpec((None, 3)))
    return ours, ref


def test_apply_batch_injected_oom_matches_reference():
    """One OOM injected at the first bucket: both packages re-chunk once
    (the same health counters), and the port's rows are bit-identical to
    its uninjected run and within float32 of the reference's."""
    ours, ref = _linear_models()
    arr = np.random.default_rng(42).normal(size=(50, 3)).astype(np.float32)
    baseline = ours.apply_batch(arr, batch_size=16, device="cpu")
    with FaultInjector.seeded(0, device_oom=1), \
            health.HealthMonitor() as mon:
        out = ours.apply_batch(arr, batch_size=16, device="cpu")
    with jax_res.FaultInjector.seeded(0, device_oom=1), \
            jax_health.HealthMonitor() as jmon:
        jout = np.asarray(ref.apply_batch(arr, batch_size=16))
    assert np.array_equal(out, baseline)
    assert mon.report()["counters"] == jmon.report()["counters"] == \
        {"oom_rechunk": 1}
    np.testing.assert_allclose(out, jout, rtol=1e-6)


def test_apply_batch_fatal_error_not_retried():
    calls = []

    def bad(vs, x):
        calls.append(1)
        raise ValueError("deliberate shape error")

    mf = ModelFunction.fromFunction(bad, None, TensorSpec((None, 3)))
    with pytest.raises(ValueError, match="deliberate"):
        mf.apply_batch(np.zeros((4, 3), np.float32), batch_size=4,
                       device="cpu")
    assert len(calls) == 1


def test_apply_batch_escaping_oom_halves_batch_size(monkeypatch):
    """An OOM escaping ``run_batched`` re-runs the whole call at half the
    batch size and drops the planner; the rows are those of a clean run."""
    ours, _ = _linear_models()
    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    baseline = ours.apply_batch(arr, batch_size=8, device="cpu")
    seen = []
    original = batching.run_batched

    def oom_once(fn, array, batch_size, device, **kw):
        seen.append((batch_size, kw["planner"] is None))
        if len(seen) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (fetch)")
        return original(fn, array, batch_size, device, **kw)

    monkeypatch.setattr(batching, "run_batched", oom_once)
    planner = batching.BucketPlanner(8, name="linear")
    out = ours.apply_batch(arr, batch_size=8, device="cpu", planner=planner)
    assert seen == [(8, False), (4, True)]
    np.testing.assert_array_equal(out, baseline)
