"""Resilience kernel: error taxonomy, retry/backoff, deadlines, fault injection.

A port of ``sparkdl_tpu.core.resilience``, standard library only, so every
layer of the port — engine, core, image, ml — imports it without cycles.
It is the single source of truth for *what is worth retrying* and *how*:

- :func:`classify` splits failures into ``FATAL`` (shape/dtype/programming
  errors — retrying reproduces them bit-for-bit), ``OOM`` (device
  allocator exhaustion — retrying at the same batch shape reproduces it,
  but a *smaller* batch can succeed), and ``RETRYABLE`` (preemption,
  transfer stalls, transient runtime errors — the task boundary default).
  The reference's precedence and markers are kept unchanged. The CUDA
  runtime's own failures map onto the same three kinds: PyTorch's
  ``torch.OutOfMemoryError`` ("CUDA out of memory") is ``OOM`` through the
  ``out of memory`` marker, and a sticky CUDA error (an illegal memory
  access, a device-side assert, an unspecified launch failure) is
  ``FATAL``: the context is dead, and a retry in the same process replays
  the failure.
- :class:`RetryPolicy` provides exponential backoff with *deterministic*
  jitter: two processes with the same seed compute identical delays (the
  reference's delays, bit for bit).
- :class:`Deadline` bounds total retry time.
- :class:`FaultInjector` arms named injection points (see
  :data:`INJECTION_POINTS`) so every retry/degradation path is
  deterministically exercisable on the CPU — no real device fault
  required.
"""

from __future__ import annotations

import logging
import random
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Union

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

#: Failure kinds returned by :func:`classify`.
FATAL = "fatal"
RETRYABLE = "retryable"
OOM = "oom"


class InjectedFault(RuntimeError):
    """Base class for all errors raised by :class:`FaultInjector`."""


class DeviceOOM(InjectedFault):
    """Simulated device allocator exhaustion (the reference's message,
    XLA's ``RESOURCE_EXHAUSTED``, which :func:`classify` reads as OOM as it
    does PyTorch's "CUDA out of memory")."""

    def __init__(self, msg: str = "RESOURCE_EXHAUSTED: injected device OOM"
                 ) -> None:
        super().__init__(msg)


class Preemption(InjectedFault):
    """Simulated preemption / worker loss (gang failure)."""

    def __init__(self, msg: str = "injected preemption: coordinator "
                 "reported worker UNAVAILABLE") -> None:
        super().__init__(msg)


class TransferStall(InjectedFault):
    """Simulated transient host↔device transfer failure."""

    def __init__(self, msg: str = "injected transfer stall: "
                 "DEADLINE_EXCEEDED staging batch to device") -> None:
        super().__init__(msg)


class WorkerFault(InjectedFault):
    """Simulated engine worker/task failure (a partition task dying mid-run
    or after computing but before delivering its result — RETRYABLE)."""

    def __init__(self, msg: str = "injected worker fault: partition task "
                 "lost (UNAVAILABLE)") -> None:
        super().__init__(msg)


class DeadlineExceeded(RuntimeError):
    """A :class:`Deadline` expired before the guarded work completed."""


class ExecutorOverloaded(RuntimeError):
    """The device execution service shed this request at admission (its
    per-fn queue bound was exceeded in shed mode, or an interactive
    arrival displaced this queued bulk request). RETRYABLE by
    definition: overload is transient, and the engine's classified task
    retry (``run_partition_task``) absorbs the spike with backoff.
    Defined here (not in core.executor) so :func:`classify` stays the
    single taxonomy source without an import cycle."""


class ExecutorCircuitOpen(RuntimeError):
    """The per-model circuit breaker is open: this model's recent
    launches failed terminally, so the service fails fast instead of
    queuing doomed work. RETRYABLE: the caller's bounded backoff rides
    past the cooldown, after which a half-open probe re-tests the model
    — if it healed, traffic flows again; if not, the retry budget
    exhausts without ever paying for a queue slot or a launch."""


class DecodeWorkerLost(RuntimeError):
    """A decode-pool worker process died (or the pool closed) while a
    chunk was in flight and the pool's internal respawn+resubmit budget
    could not recover it (``core/decode_pool.py``). RETRYABLE by
    definition: worker loss is transient infrastructure failure — the
    engine's classified task retry replays the partition, and the pool
    has already respawned its workers by the time the retry arrives.
    Defined here (not in core.decode_pool) so :func:`classify` stays the
    single taxonomy source without an import cycle."""


class ClusterWorkerLost(RuntimeError):
    """A cluster worker process died (EOF on its result pipe) while a
    partition dispatch was in flight and no survivor could absorb the
    re-dispatch (``sparkdl_tpu/cluster/router.py``). RETRYABLE by
    definition: worker loss is transient infrastructure failure — the
    engine's classified task retry re-dispatches the partition, and the
    router re-routes around the dead worker. Defined here (not in the
    cluster package) so :func:`classify` stays the single taxonomy
    source without an import cycle."""


class WorkerDraining(RuntimeError):
    """A task was routed to (or refused by) a cluster worker that is
    draining: it received a preemption warning or a scale-down order and
    accepts no new dispatches while its in-flight tasks finish
    (``sparkdl_tpu/cluster/router.py``). RETRYABLE by definition: the
    work itself is untouched — another worker (or a freshly spawned
    replacement) can run it immediately, and journal-committed
    partitions never re-execute. Defined here (not in the cluster
    package) so :func:`classify` stays the single taxonomy source
    without an import cycle."""


class DrainTimeout(RuntimeError):
    """A draining cluster worker failed to finish its in-flight tasks
    before the drain grace period expired (the preemptor's warning
    window, ``sparkdl_tpu/cluster/router.py``) and was torn down hard.
    RETRYABLE by definition: the interrupted tasks are indistinguishable
    from worker loss — the router re-dispatches them to survivors, and
    journal-committed partitions stay committed. Defined here so
    :func:`classify` stays the single taxonomy source without an import
    cycle."""


class ServingReplicaLost(RuntimeError):
    """A cluster worker serving an online predict died (or every
    surviving replica was draining/lost) and the request could not be
    re-admitted within its failover budget
    (``sparkdl_tpu/serving/cluster.py``). RETRYABLE by definition:
    predict is idempotent and journal-free — the client (or the serving
    router's own deadline-bounded re-admission) simply runs it again on
    a surviving replica. Defined here so :func:`classify` stays the
    single taxonomy source without an import cycle."""


class StaleCheckpointWriter(RuntimeError):
    """A checkpoint save was refused by the fencing token: this process
    belongs to a superseded gang incarnation and a newer writer has
    claimed the directory (``train/checkpoint.py``). FATAL by definition:
    the zombie must die, not retry — every retry would be refused again,
    and letting it through would clobber the newer incarnation's
    checkpoints. Defined here so :func:`classify` stays the single
    taxonomy source without an import cycle."""


# Exception types whose recurrence is deterministic: retrying replays the
# same traceback. ValueError covers shape/dtype contract violations raised
# throughout the framework; jax shape errors are TypeError subclasses.
_FATAL_TYPES: Tuple[type, ...] = (
    ValueError, TypeError, KeyError, IndexError, AttributeError,
    AssertionError, NotImplementedError, ZeroDivisionError,
)

# Message fragments marking device allocator exhaustion (XLA / PJRT wording
# differs per backend+version — status prefix, BFC-allocator prose, bare
# "OOM"; prose matches case-insensitively). "OOM" matches as a standalone
# word only — an unanchored substring would classify e.g. "BLOOM shard
# failed" as a device OOM and burn bucket-halving retries on a
# deterministic error.
_OOM_MARKERS = ("resource_exhausted", "out of memory", "resource exhausted")
_OOM_WORD = re.compile(r"\bOOM\b")

# Message fragments marking transient infrastructure failures (gRPC status
# names the PJRT C API surfaces verbatim, plus prose seen from the TPU
# runtime during preemption/migration events). Checked BEFORE the fatal
# type list: a transient infra failure re-raised through a fatal-typed
# wrapper (e.g. ValueError("UNAVAILABLE: socket closed")) must stay
# retryable.
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                      "CANCELLED", "preempt", "socket closed",
                      "connection reset", "Broken pipe")

# Message fragments of the CUDA runtime's sticky errors: after one of
# these the context is dead, every later call in the process fails the
# same way, and only a new process recovers — FATAL, never retried here.
_STICKY_CUDA_MARKERS = ("illegal memory access", "device-side assert",
                        "unspecified launch failure",
                        "illegal instruction", "misaligned address")


def classify(err: BaseException) -> str:
    """Classify an exception as ``FATAL``, ``OOM``, or ``RETRYABLE``.

    Precedence: explicit injected types first; then OOM markers (an XLA
    ``RESOURCE_EXHAUSTED`` arrives as a RuntimeError-ish ``XlaRuntimeError``
    whose *message* carries the status); then transient infra markers
    (which override a fatal wrapper type); then the deterministic-failure
    type list (after the sticky CUDA errors, which are FATAL whatever
    their type); everything else falls to ``RETRYABLE`` — the gang boundary
    has always retried unknown errors (Spark task semantics) and a
    spurious retry is bounded by the policy, while a missed retry loses
    the job.

    An exception carrying a ``failure_kind`` attribute (the engine's
    ``TaskFailure``, which records its terminal attempt's classification)
    is trusted verbatim — a task that failed FATALLY must stay fatal
    through every wrapper, or a gang restart would replay it.
    """
    kind = getattr(err, "failure_kind", None)
    if kind in (FATAL, OOM, RETRYABLE):
        return kind
    if isinstance(err, DeviceOOM):
        return OOM
    if isinstance(err, (Preemption, TransferStall, ExecutorOverloaded,
                        ExecutorCircuitOpen, DecodeWorkerLost,
                        ClusterWorkerLost, WorkerDraining, DrainTimeout,
                        ServingReplicaLost)):
        return RETRYABLE
    if isinstance(err, DeadlineExceeded):
        return FATAL  # the deadline IS the retry budget; never retry past it
    if isinstance(err, StaleCheckpointWriter):
        return FATAL  # fenced-off zombie: every retry would be refused too
    msg = str(err)
    msg_lower = msg.lower()
    if any(m in msg_lower for m in _OOM_MARKERS) or _OOM_WORD.search(msg):
        return OOM
    if any(m in msg_lower for m in _STICKY_CUDA_MARKERS):
        return FATAL
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return RETRYABLE
    if isinstance(err, _FATAL_TYPES):
        return FATAL
    if "INVALID_ARGUMENT" in msg or "FAILED_PRECONDITION" in msg:
        return FATAL
    return RETRYABLE


# ---------------------------------------------------------------------------
# Deadline
# ---------------------------------------------------------------------------

class Deadline:
    """A wall-clock budget: ``Deadline(30).check()`` raises once exceeded.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``).
    ``Deadline(None)`` never expires — callers can thread one value
    unconditionally.
    """

    def __init__(self, timeout_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self.timeout_s = timeout_s
        self._start = clock()

    def remaining(self) -> float:
        if self.timeout_s is None:
            return float("inf")
        return self.timeout_s - (self._clock() - self._start)

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"{what} exceeded its {self.timeout_s}s deadline")


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def _jitter_seed(seed: int, attempt: int) -> int:
    """The integer the reference's ``random.Random((seed, attempt))``
    seeded from: before Python 3.11 a tuple seeded by its hash, cast to
    an unsigned 64-bit integer (a tuple of ints hashes the same in every
    process). Python 3.11 refuses a tuple seed, so the port passes the
    integer itself and keeps the reference's delays bit for bit."""
    return hash((seed, attempt)) & 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``delay(attempt)`` for attempt 1, 2, ... grows as
    ``base_delay_s * multiplier**(attempt-1)`` capped at ``max_delay_s``,
    then stretched by up to ``jitter`` (a fraction) drawn from an RNG
    seeded by ``(seed, attempt)`` — deterministic per policy, so restarts
    are reproducible and multi-host gangs with a shared seed back off in
    lockstep.
    """

    max_retries: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-indexed)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-indexed, got {attempt}")
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        if not self.jitter or base <= 0:
            return base
        frac = random.Random(_jitter_seed(self.seed, attempt)).uniform(
            0.0, self.jitter)
        return base * (1.0 + frac)

    def execute(self, fn: Callable[[], Any], *,
                deadline: Optional[Deadline] = None,
                on_retry: Optional[Callable[[int, BaseException], None]] = None,
                sleep: Callable[[float], None] = time.sleep,
                what: str = "operation") -> Any:
        """Run ``fn`` with classified retry; FATAL/OOM propagate immediately.

        OOM is *not* retried here because same-shape retry reproduces it —
        callers with a smaller-batch fallback (core.batching) handle OOM
        themselves and use this only for the transient class.
        """
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                kind = classify(e)
                if kind != RETRYABLE:
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    raise
                if deadline is not None:
                    deadline.check(what)
                if on_retry is not None:
                    on_retry(attempt, e)
                d = self.delay(attempt)
                logger.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                               what, type(e).__name__, e, attempt,
                               self.max_retries, d)
                if d > 0:
                    sleep(d)


# Shared default for the inference hot path (apply_batch / run_batched):
# short fuse, small base delay — a transform must not stall for minutes on
# a partition, and the engine's task retry sits above it anyway.
DEFAULT_INFERENCE_POLICY = RetryPolicy(max_retries=2, base_delay_s=0.2,
                                       max_delay_s=5.0)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

#: Registered injection points → (description, default error factory or
#: None for behavioral points that degrade instead of raising): the
#: reference's registry, unchanged, so one arming is valid for either
#: package. The port fires ``device_oom``, ``transfer_stall``,
#: ``engine_task`` and ``task_stall`` so far.
INJECTION_POINTS: Dict[str, Tuple[str, Optional[Callable[[], BaseException]]]] = {
    "device_oom": ("raised per inference chunk before device dispatch "
                   "(core.batching) — exercises the OOM bucket-halving "
                   "fallback", DeviceOOM),
    "preemption": ("raised per training step after checkpointing "
                   "(train.trainer) — exercises TPURunner's classified "
                   "gang restart + checkpoint resume", Preemption),
    "transfer_stall": ("raised per inference chunk before device dispatch "
                       "(core.batching) — exercises transient retry",
                       TransferStall),
    "decode_error": ("behavioral: image decode paths (image.imageIO, "
                     "ml.image_transformer) treat the row as undecodable "
                     "— exercises null-cell degradation", None),
    "checkpoint_truncate": ("behavioral: CheckpointManager.save corrupts "
                            "the just-written step — exercises restore "
                            "fallback to the previous retained step", None),
    "engine_task": ("raised per partition-task attempt in the engine "
                    "executor (engine/dataframe); ctx carries partition, "
                    "attempt, and phase ('start' before the op chain, "
                    "'finish' after it — a worker dying before delivering "
                    "its computed result) — exercises classified task "
                    "retry", WorkerFault),
    "task_stall": ("behavioral: the engine partition task hangs (sleeps "
                   "past its deadline) instead of failing — exercises the "
                   "supervisor's deadline watchdog", None),
    "decode_pool_worker_crash": (
        "behavioral: the decode pool marks the next submitted chunk so "
        "its worker process exits hard (os._exit) mid-task "
        "(core/decode_pool.py) — exercises worker respawn, chunk "
        "resubmission, and (armed persistently) the RETRYABLE "
        "DecodeWorkerLost exhaustion path", None),
    "process_kill": (
        "behavioral: the durable journal SIGKILLs its own process "
        "immediately AFTER committing a partition record "
        "(core/durability.py); ctx carries partition — exercises "
        "kill -9 resume: a restarted job must load the committed "
        "partitions from spill and recompute only the rest", None),
    "cluster_worker_kill": (
        "behavioral: the cluster router marks the next dispatched "
        "partition so its worker process SIGKILLs itself on receipt "
        "(sparkdl_tpu/cluster/); ctx carries partition — exercises "
        "EOF death detection, precise re-dispatch of the dead worker's "
        "in-flight partitions to survivors, and the merged-report "
        "accounting for a lost worker", None),
    "serving_worker_kill": (
        "behavioral: the cluster serving router marks the next "
        "dispatched predict so its worker process SIGKILLs itself on "
        "receipt (sparkdl_tpu/serving/cluster.py); ctx carries model "
        "and request — exercises replica-death failover: every "
        "in-flight predict on the dead worker re-admits to a surviving "
        "replica within the caller's deadline, with exactly-once "
        "serving_failover accounting", None),
    "cluster_worker_preempt": (
        "behavioral: the cluster router marks the next dispatched "
        "partition so its worker process SIGTERMs itself on receipt — "
        "a spot-VM preemption WARNING, not a kill: the worker still "
        "runs the task, notifies the router it is draining, and exits "
        "cleanly once drained (sparkdl_tpu/cluster/); ctx carries "
        "partition — exercises graceful drain with zero re-execution "
        "instead of the ClusterWorkerLost re-dispatch path", None),
}


@dataclass
class Fault:
    """Arming spec for one injection point.

    Fires on checks ``after <= i < after + times`` (0-indexed occurrence
    count, per point, counted only on checks where ``when(ctx)`` holds).
    ``times=-1`` fires forever. ``error`` overrides the point's default
    error factory (ignored for behavioral points).
    """

    times: int = 1
    after: int = 0
    when: Optional[Callable[[Dict[str, Any]], bool]] = None
    error: Optional[Union[Callable[[], BaseException], BaseException]] = None
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def should_fire(self, ctx: Dict[str, Any]) -> bool:
        if self.when is not None and not self.when(ctx):
            return False
        i = self._seen
        self._seen += 1
        if i < self.after:
            return False
        if self.times != -1 and self._fired >= self.times:
            return False
        self._fired += 1
        return True


class FaultInjector:
    """Seeded, named fault injection — a context manager arming the
    process-wide injector (process-wide, not context-local: partition ops
    run on engine pool threads where a ContextVar scope entered on the
    driver thread would be invisible).

    ::

        with FaultInjector.seeded(0, device_oom=1):
            model.apply_batch(x)            # first chunk OOMs, then heals
        with FaultInjector.seeded(0, engine_task=Fault(
                when=lambda ctx: ctx.get("partition") == 3)):
            df.collect()                    # partition 3 retries once

    ``seed`` feeds the deterministic jitter of any policy built from
    :meth:`retry_policy` and is recorded for reproducibility. Fire counts
    are observable via :attr:`fired` for assertions.
    """

    def __init__(self, faults: Dict[str, Fault], seed: int = 0) -> None:
        unknown = set(faults) - set(INJECTION_POINTS)
        if unknown:
            raise ValueError(
                f"Unknown injection point(s) {sorted(unknown)}; "
                f"registered: {sorted(INJECTION_POINTS)}")
        self.faults = faults
        self.seed = seed
        self.fired: Dict[str, int] = {name: 0 for name in faults}
        self._lock = threading.Lock()
        self._prev: Optional["FaultInjector"] = None

    @classmethod
    def seeded(cls, seed: int = 0, **faults) -> "FaultInjector":
        """Build from kwargs: ``point=N`` (fire N times), ``point=Fault(...)``,
        or ``point=<exception instance/class>`` (fire once with it)."""
        specs: Dict[str, Fault] = {}
        for name, value in faults.items():
            if isinstance(value, Fault):
                specs[name] = value
            elif isinstance(value, bool):
                specs[name] = Fault(times=-1 if value else 0)
            elif isinstance(value, int):
                specs[name] = Fault(times=value)
            elif isinstance(value, BaseException) or (
                    isinstance(value, type)
                    and issubclass(value, BaseException)):
                specs[name] = Fault(times=1, error=value)
            else:
                raise TypeError(
                    f"{name}={value!r}: expected int, bool, Fault, or an "
                    "exception")
        return cls(specs, seed=seed)

    def retry_policy(self, **overrides) -> RetryPolicy:
        """A policy sharing this injector's seed (deterministic delays)."""
        return RetryPolicy(seed=self.seed, **overrides)

    # -- the check, called from injection sites ------------------------------

    def _fire(self, point: str, ctx: Dict[str, Any]
              ) -> Optional[BaseException]:
        fault = self.faults.get(point)
        if fault is None:
            return None
        with self._lock:
            if not fault.should_fire(ctx):
                return None
            self.fired[point] += 1
        desc, default_error = INJECTION_POINTS[point]
        err = fault.error if fault.error is not None else default_error
        if err is None:
            return InjectedFault(f"injected {point}")  # behavioral marker
        if isinstance(err, BaseException):
            return err
        return err()

    # -- activation ----------------------------------------------------------

    def __enter__(self) -> "FaultInjector":
        global _active
        with _activation_lock:
            self._prev = _active
            _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        with _activation_lock:
            _active = self._prev
            self._prev = None


_active: Optional[FaultInjector] = None
_activation_lock = threading.Lock()


def active_injector() -> Optional[FaultInjector]:
    return _active


def inject(point: str, **ctx: Any) -> None:
    """Raise the armed fault at ``point`` (no-op with no active injector).

    Production cost when idle: one global read + None check.
    """
    injector = _active
    if injector is None:
        return
    err = injector._fire(point, ctx)
    if err is not None:
        logger.warning("FaultInjector: firing %r (%s)", point, err)
        raise err


def should_fire(point: str, **ctx: Any) -> bool:
    """Behavioral variant: True when the armed fault at ``point`` fires.

    Used where injection means *degrading* (undecodable row, truncated
    checkpoint) rather than raising.
    """
    injector = _active
    if injector is None:
        return False
    fired = injector._fire(point, ctx) is not None
    if fired:
        logger.warning("FaultInjector: firing behavioral point %r", point)
    return fired
