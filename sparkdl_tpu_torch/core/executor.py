"""Device execution service: cross-partition dynamic batch coalescing.

A port of ``sparkdl_tpu.core.executor``. Every engine partition task
(``engine/dataframe.py`` pool → transformer op → ``ModelFunction.
apply_batch``) would otherwise stage its own ≤ ``batch_size`` chunk and
replay its own captured graph, so a 16-way partitioned frame of 4 images
each replays the rung-4 graph 16 times, with the host work between the
replays serialized.

Transformers enter the device through ONE choke point, :func:`execute`,
which decides the precision (``EngineConfig.inference_precision``, through
``ModelFunction.with_dtype``) and the device (``EngineConfig.device``)
once, and concurrent small requests against the same compiled program
(``ModelFunction.jitted``) are **coalesced** into one padded bucket
launch:

- worker threads submit ``(program, rows)`` requests to a per-program
  queue;
- a coalescer thread (its device pinned, inference mode entered) drains
  the queue under a bounded wait window (``EngineConfig.
  coalesce_window_ms``; default an adaptive fraction of the observed
  request latency) and a max-bucket cap, concatenates the requests into
  one slot of a pinned staging ring padded to its rung, replays that
  rung's CUDA graph, slices each request's output rows back **on the
  device**, records an event after the slices, and completes the
  requesters' futures in submission order; each requester's stream waits
  on that event and pays its own single device-to-host copy of exactly
  its rows. The ring slot is handed back only after an event recorded
  behind its upload has completed;
- a **solo request under no contention takes the inline path**
  (``apply_batch`` on the caller's thread) with no added latency — the
  service only changes behavior when there is someone to coalesce with.

Composition with the other layers:

- **order-preserving**: every requester gets its rows back in its own
  submission order. On the CPU, with a row-wise model, a coalesced
  launch is bit-identical to per-request launches. On the card a
  coalesced window replays a larger rung's graph than a request alone
  would, and a library convolution may pick another algorithm per batch
  size, so the rows agree within the model's tolerance and need not be
  equal to the last bit;
- **resilience**: ANY failure of a coalesced launch (transient, OOM,
  FATAL) splits it back into per-request launches via ``apply_batch``
  on the requesters' own threads, on the card, through the same
  graphs: a transient's classified retry runs per request (never a
  sleep on the coalescer thread), an OOM re-chunks exactly as the
  non-coalesced path would, and a poisoned request fails alone. Nothing
  falls back to the CPU or to an eager forward;
- **supervision**: the supervisor's deadline watchdog and hedging bound
  each *task* as before; a hedged duplicate attempt carries its task's
  token (:func:`task_scope`, set by ``engine/supervisor.py``) and
  **dedups before coalescing** while its sibling's request is still
  queued;
- **telemetry**: coalesce-size and queue-wait histograms, a launch
  histogram and the executor's occupancy, queue-depth and shed-rate
  gauges.

Shutdown never leaks a future: :func:`shutdown` fails every queued
request with :class:`ExecutorShutdown`. Shutdown and :func:`reset` are
idempotent and safe to race with concurrent submits.

Overload protection — every knob defaults to unbounded behavior:
admission control (``executor_max_queued_requests`` /
``executor_max_queued_rows``, blocking with backpressure or shedding
with :class:`~sparkdl_tpu_torch.core.resilience.ExecutorOverloaded`),
deadline propagation (:class:`deadline_scope`; expired requests are
dropped at drain time), interactive/bulk priority lanes, a per-model
circuit breaker (``executor_breaker_*``,
:class:`~sparkdl_tpu_torch.core.resilience.ExecutorCircuitOpen`), and
per-tenant deficit-round-robin within a lane
(``executor_tenant_weights``, :class:`tenant_scope`).

Eviction: :meth:`DeviceExecutor.retire_model` drops every idle
coalescing state that pins a model or one of its variants and wakes its
parked coalescer, so the serving plane's residency manager can free a
model's weights and graphs.

The mesh ``multiple=``, pytree inputs and buffer donation are not ported
yet.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.core import batching, health, resilience, telemetry
from sparkdl_tpu_torch.core.resilience import (  # noqa: F401 - re-exported
    ExecutorCircuitOpen,
    ExecutorOverloaded,
)

logger = logging.getLogger(__name__)

# Adaptive window bounds (seconds) when EngineConfig.coalesce_window_ms is
# None: a fraction of the observed end-to-end request latency, clamped so
# the window neither busy-spins on microsecond models nor adds visible
# latency to slow ones.
_WINDOW_FRACTION = 0.25
_WINDOW_MIN_S = 0.0005
_WINDOW_MAX_S = 0.02
_WINDOW_DEFAULT_S = 0.002
def _idle_exit_s() -> float:
    """How long an idle coalescer thread (and its state) lives:
    ``EngineConfig.executor_idle_retire_s``, read at each use so a knob
    flip reaches parked threads at their next wakeup (imported here:
    core imports no engine module at load)."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    return float(EngineConfig.executor_idle_retire_s)


class ExecutorShutdown(RuntimeError):
    """The execution service was shut down with this request still queued."""


# Priority lanes: interactive drains first and is shed last. Bulk is the
# default — batch featurize must OPT OUT of being sheddable, never the
# other way around.
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BULK = "bulk"
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_BULK)

# Tick for the blocking-admission wait: short enough that a caller whose
# deadline expires mid-wait notices promptly, long enough not to spin.
_ADMIT_WAIT_TICK_S = 0.05


@dataclass(frozen=True)
class OverloadPolicy:
    """Per-submit snapshot of the EngineConfig overload knobs (read once
    in :func:`execute`, so a knob flip mid-run can't tear one request's
    admission decision). All defaults mean "today's behavior": unbounded
    queue, no shedding, breaker disabled."""

    max_queued_requests: Optional[int] = None
    max_queued_rows: Optional[int] = None
    shed: bool = False          # False = block with backpressure
    breaker_threshold: int = 0  # 0 disables the circuit breaker
    breaker_window_s: float = 30.0
    breaker_cooldown_s: float = 1.0

    @property
    def bounded(self) -> bool:
        return (self.max_queued_requests is not None
                or self.max_queued_rows is not None)


_NO_OVERLOAD = OverloadPolicy()


# ---------------------------------------------------------------------------
# Task tokens (hedge dedup)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_task_token() -> Optional[Tuple]:
    """The ambient dedup identity for THIS executor call: the task token
    set by :func:`task_scope` extended with the attempt's call sequence
    number. Ops are pure and deterministic (the engine contract), so the
    N-th device call of a task's hedge attempt computes the same rows as
    the N-th call of its primary — the sequence number keeps a task whose
    op chain enters the device several times (e.g. two chained
    transformers sharing one model) from dedup'ing call N onto call M.
    Each read advances the sequence. None outside a scope."""
    token = getattr(_tls, "token", None)
    if token is None:
        return None
    seq = _tls.seq
    _tls.seq = seq + 1
    return token + (seq,)


def reset_call_sequence() -> None:
    """Restart the ambient token's device-call sequence. The supervisor
    calls this at the start of EVERY retry-loop attempt inside a pool
    attempt's :class:`task_scope` (``run_partition_task``'s classified
    retries re-run the op chain from the top, so their device calls
    restart at call 0) — without the reset a retried primary's call 0
    would sit at seq N while a fresh hedge's call 0 sits at seq 0, and
    the hedge's call N could dedup onto the WRONG device call's output.
    No-op outside a scope."""
    if getattr(_tls, "token", None) is not None:
        _tls.seq = 0


class task_scope:
    """Mark device requests from this thread as belonging to one logical
    task attempt. The supervisor wraps every pool attempt (primary,
    retry, hedge) of a task in the SAME token (each attempt — including
    each retry-loop attempt inside a pool attempt, via
    :func:`reset_call_sequence` — restarting the call-sequence counter),
    so a hedged duplicate submitting the same rows while its sibling's
    request is still pending shares that request's future instead of
    coalescing the rows twice."""

    def __init__(self, token: Tuple) -> None:
        self._token = token
        self._prev: Optional[Tuple] = None
        self._prev_seq = 0

    def __enter__(self) -> "task_scope":
        self._prev = getattr(_tls, "token", None)
        self._prev_seq = getattr(_tls, "seq", 0)
        _tls.token = self._token
        _tls.seq = 0
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.token = self._prev
        _tls.seq = self._prev_seq


def current_deadline() -> Optional[resilience.Deadline]:
    """The ambient task deadline for THIS thread's executor calls (set by
    :class:`deadline_scope`; the supervisor enters one per task attempt).
    None outside a scope."""
    return getattr(_tls, "deadline", None)


class deadline_scope:
    """Thread the caller's :class:`~sparkdl_tpu.core.resilience.Deadline`
    into every executor call made on this thread. ``run_partition_task``
    wraps each task in one, so a queued request knows its budget: the
    blocking admission wait is bounded by it, and the coalescer drops a
    request whose deadline already expired at drain time — before paying
    for a launch — instead of turning one slow window into a convoy of
    doomed launches. A ``Deadline(None)`` (no budget) is not threaded:
    the unloaded hot path stays free of per-request expiry checks."""

    def __init__(self, deadline: Optional[resilience.Deadline]) -> None:
        self._deadline = (deadline if deadline is not None
                          and deadline.timeout_s is not None else None)
        self._prev: Optional[resilience.Deadline] = None

    def __enter__(self) -> "deadline_scope":
        self._prev = getattr(_tls, "deadline", None)
        _tls.deadline = self._deadline
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.deadline = self._prev


#: Tenant tag for requests that carry none and run outside any scope.
DEFAULT_TENANT = "default"


def current_tenant() -> Optional[str]:
    """The ambient tenant tag for THIS thread's executor calls (set by
    :class:`tenant_scope`). None outside a scope."""
    return getattr(_tls, "tenant", None)


class tenant_scope:
    """Tag every executor call made on this thread with one tenant.
    The fair-queueing coalescer schedules lanes per tenant
    (deficit-round-robin within priority), so the tag decides whose
    quota a request burns. Explicit ``execute(tenant=...)`` beats the
    scope; the scope beats ``EngineConfig.executor_default_tenant``.
    ``tenant_scope(None)`` is a no-op layer (ambient tag unchanged)."""

    def __init__(self, tenant: Optional[str]) -> None:
        self._tenant = tenant
        self._prev: Optional[str] = None

    def __enter__(self) -> "tenant_scope":
        self._prev = getattr(_tls, "tenant", None)
        if self._tenant is not None:
            _tls.tenant = self._tenant
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.tenant = self._prev


# ---------------------------------------------------------------------------
# Requests and per-compiled-fn state
# ---------------------------------------------------------------------------


class _ReplayInline:
    """Sentinel future result: the coalescer handed the request back for
    the REQUESTER'S OWN thread to run via ``apply_batch`` (solo drained
    window, or a member of a terminally-failed super-batch). Executing
    these on the coalescer thread would serialize device work that pool
    threads previously overlapped — and block every queued sibling
    behind one request's fetch and retry-backoff sleeps."""

    __slots__ = ()


_REPLAY_INLINE = _ReplayInline()


class _Request:
    """One queued submission: host-staged rows + the future that will carry
    the ON-DEVICE output slices back to the requester."""

    __slots__ = ("tree", "rows", "future", "token", "policy", "ctx",
                 "t_enqueue", "launched", "priority", "deadline",
                 "tenant", "is_probe", "breaker_noted")

    def __init__(self, tree: Any, rows: int, token: Optional[Tuple],
                 policy: resilience.RetryPolicy,
                 priority: str = PRIORITY_BULK,
                 deadline: Optional[resilience.Deadline] = None,
                 tenant: str = DEFAULT_TENANT) -> None:
        self.tree = tree
        self.rows = rows
        self.future: "Future[Any]" = Future()
        self.token = token
        self.policy = policy
        self.priority = priority
        self.deadline = deadline
        self.tenant = tenant
        # True when this request is the breaker's half-open probe: its
        # outcome decides reopen-vs-close, and a probe that dies WITHOUT
        # reaching the device must release the probe slot (never wedge
        # the breaker half-open)
        self.is_probe = False
        # set-exception failures are breaker-counted ONCE per request —
        # a plumbing failure fanned out to a whole window, or two hedged
        # waiters sharing one dedup'd future, must not multiply one
        # launch failure into several breaker counts
        self.breaker_noted = False
        self.ctx = telemetry.current_context()
        self.t_enqueue = time.monotonic()
        # set when the coalescer drains this request: dedup only shares
        # PRE-launch requests, so a hedge arriving later re-executes
        # independently and speculation can still win past a launch that
        # stalled on the device
        self.launched = False


class _FnState:
    """Coalescing state for one compiled fn (one bucket ladder).

    Keyed by the compiled program's identity — a strong reference is held
    here, so the id can never be recycled while the state exists. All
    fields are guarded by ``cond``'s lock except the immutable config.
    """

    def __init__(self, key: Tuple, fn: Any, model: Any, batch_size: int,
                 device: torch.device) -> None:
        self.key = key
        self.fn = fn
        self.model = model
        self.batch_size = batch_size
        self.device = device
        # pinned staging rings of the coalescer thread, by element
        # signature (batching._PinnedRing, one bucket of batch_size rows
        # a slot); given back when the thread exits
        self.rings: Dict[Tuple, Any] = {}
        self.cond = threading.Condition()
        self.pending: "deque[_Request]" = deque()
        self.pending_rows = 0       # incremental sum(r.rows for pending)
        self.pending_deadlines = 0  # queued requests carrying a deadline
        # Deficit-round-robin credit per tenant (guarded by cond): rows
        # each tenant may still release this scheduling round. Cleared
        # for a tenant once it has nothing queued, so an idle tenant
        # cannot bank unbounded credit.
        self.tenant_deficit: Dict[str, float] = {}
        self.dedup: Dict[Tuple, _Request] = {}
        self.inflight = 0           # launches running (inline + coalesced)
        self.window_s: Optional[float] = None  # None = adaptive
        self.cap = batch_size
        self.overload: OverloadPolicy = _NO_OVERLOAD
        # DRR weight per tenant (None = every tenant weight 1); snapshot
        # of EngineConfig.executor_tenant_weights, refreshed per submit
        # like the overload policy.
        self.tenant_weights: Optional[Dict[str, int]] = None
        self.planner: Optional[batching.BucketPlanner] = None
        self.latency_ewma: Optional[float] = None
        self.thread: Optional[threading.Thread] = None
        self.last_used = time.monotonic()
        # Circuit breaker (closed -> open -> half_open -> closed); all
        # guarded by cond. breaker_failures holds terminal-failure
        # timestamps inside the rolling window.
        self.breaker_state = "closed"
        self.breaker_failures: "deque[float]" = deque()
        self.breaker_opened_at = 0.0
        self.breaker_probe_inflight = False
        self.retired = False  # set by retire_model: exit at next wakeup

    def effective_window(self) -> float:
        if self.window_s is not None:
            return self.window_s
        if self.latency_ewma is None:
            return _WINDOW_DEFAULT_S
        return min(max(self.latency_ewma * _WINDOW_FRACTION,
                       _WINDOW_MIN_S), _WINDOW_MAX_S)

    def note_latency(self, seconds: float) -> None:
        prev = self.latency_ewma
        self.latency_ewma = (seconds if prev is None
                             else 0.8 * prev + 0.2 * seconds)


class DeviceExecutor:
    """The process-wide coalescing service (one instance per process; the
    module-level :func:`execute` routes through :func:`service`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[Tuple, _FnState] = {}
        self._closed = False
        self._shutdown_complete = False  # idempotent-shutdown fast path
        self._thread_seq = 0
        self._inflight_total = 0  # O(1) occupancy counter (gauge source)
        self._queued_total = 0    # O(1) queue-depth counter (gauge source)
        self._admitted = 0        # bounded-admission accounting
        self._shed = 0            # (shed-rate gauge = shed/(shed+admitted))

    # -- submission ----------------------------------------------------------

    def submit(self, model: Any, array: np.ndarray, rows: int,
               batch_size: int, device: torch.device,
               policy: resilience.RetryPolicy, window_s: Optional[float],
               cap: int, prefetch: int, *, priority: str = PRIORITY_BULK,
               deadline: Optional[resilience.Deadline] = None,
               tenant: str = DEFAULT_TENANT,
               tenant_weights: Optional[Dict[str, int]] = None,
               overload: OverloadPolicy = _NO_OVERLOAD,
               planner: Optional[batching.BucketPlanner] = None
               ) -> np.ndarray:
        """Run ``rows`` staged rows through the model on ``device``,
        coalescing with any concurrent sibling requests against the same
        compiled program. Returns host numpy. Blocking.

        ``priority`` picks the lane (interactive drains first, bulk sheds
        first); ``deadline`` bounds the blocking-admission wait and lets
        the coalescer drop this request unlaunched once expired;
        ``tenant`` is the fair-queueing tag; ``overload`` carries the
        admission/breaker knob snapshot; ``planner`` is the
        telemetry-tuned bucket ladder for the coalescer's pad choice and
        the replay paths."""
        if priority not in PRIORITIES:
            # a typo'd lane would queue into a lane the coalescer never
            # drains — the caller would hang forever, not error
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        model.to(device)  # the coalescer replays over weights in place
        fn = model.jitted(device)
        state = self._state(fn, model, batch_size, device)
        token = current_task_token()
        t0 = time.monotonic()
        request: Optional[_Request] = None
        inline = False
        is_probe = False
        with state.cond:
            if self._closed:
                raise ExecutorShutdown("device execution service is shut "
                                       "down")
            state.window_s = window_s
            state.cap = cap
            state.overload = overload
            state.tenant_weights = tenant_weights
            state.planner = planner
            is_probe = self._breaker_admit_locked(state)
            try:
                if deadline is not None and deadline.expired():
                    # never queue work that is already doomed; recorded
                    # under the same event as a drain-time drop so every
                    # executor-raised DeadlineExceeded is one
                    # EXECUTOR_DEADLINE_SHED
                    health.record(health.EXECUTOR_DEADLINE_SHED,
                                  rows=rows, priority=priority,
                                  at="admission")
                    raise resilience.DeadlineExceeded(
                        f"request expired before admission (deadline "
                        f"{deadline.timeout_s}s)")
                if token is not None:
                    dup = state.dedup.get(token)
                    if (dup is not None and dup.rows == rows
                            and not dup.launched and not dup.future.done()):
                        # hedged duplicate of a sibling attempt whose
                        # request is still QUEUED: share its future — the
                        # rows coalesce exactly once. An already-launched
                        # (or inline) sibling is NOT shared: the hedge
                        # re-runs the pure ops independently, so
                        # speculation can still win past a stalled launch.
                        request = dup
                        if is_probe:
                            request.is_probe = True
                        # the shared request lives as long as the LATEST
                        # deadline among its waiters
                        if dup.deadline is not None:
                            if deadline is None:
                                dup.deadline = None
                                state.pending_deadlines -= 1
                            elif (deadline.remaining()
                                    > dup.deadline.remaining()):
                                dup.deadline = deadline
                        telemetry.count(telemetry.M_COALESCE_DEDUP)
                if request is None:
                    if state.inflight == 0 and not state.pending:
                        # solo under no contention: the inline path on
                        # the caller's thread — no added latency.
                        # inflight is bumped first so siblings arriving
                        # meanwhile queue up for the coalescer instead of
                        # serializing behind us.
                        state.inflight += 1
                        self._note_inflight(1)
                        if overload.bounded:
                            self._note_admitted()
                        inline = True
                    else:
                        if overload.bounded:
                            self._admit_locked(state, rows, priority,
                                               deadline, tenant)
                            self._note_admitted()
                        request = _Request(array, rows, token, policy,
                                           priority=priority,
                                           deadline=deadline,
                                           tenant=tenant)
                        request.is_probe = is_probe
                        state.pending.append(request)
                        state.pending_rows += rows
                        if deadline is not None:
                            state.pending_deadlines += 1
                        self._note_queued(1)
                        if token is not None:
                            state.dedup[token] = request
                        self._ensure_thread(state)
                        state.cond.notify_all()
            except BaseException:
                # a probe that never reached the device (shed, expired,
                # shutdown) must not wedge the breaker half-open
                if is_probe:
                    state.breaker_probe_inflight = False
                raise
        if not inline:
            return self._await(state, request, t0)
        try:
            with self._breaker_observe(state, is_probe=is_probe):
                return model.apply_batch(array, batch_size=batch_size,
                                         device=device,
                                         retry_policy=policy,
                                         prefetch=prefetch, planner=planner)
        finally:
            with state.cond:
                state.inflight -= 1
                state.note_latency(time.monotonic() - t0)
                self._note_inflight(-1)

    def _replay_alone(self, state: _FnState, request: _Request
                      ) -> np.ndarray:
        """This request alone through the model's own chunked path, on
        the requester's thread: its classified retry and OOM re-chunk
        apply, on the device, through the same graphs."""
        return state.model.apply_batch(
            request.tree, batch_size=state.batch_size, device=state.device,
            retry_policy=request.policy, prefetch=0, planner=state.planner)

    def _await(self, state: _FnState, request: _Request, t0: float
               ) -> np.ndarray:
        """Block on the request's future and pay the requester's single
        device-to-host copy (slices arrive on the device with the pad
        rows already cut off, with the event recorded after them, which
        this thread's stream waits on before the copy).

        A copy that fails (an error the replay left on the stream)
        re-runs THIS request alone through ``apply_batch``, unless it is
        FATAL (a sticky CUDA error: the context is dead, and a re-run
        would fail the same way). Errors delivered via ``set_exception``
        already went through per-request isolation and propagate
        as-is."""
        try:
            out = request.future.result()  # isolated failures raise here
        except BaseException as e:  # noqa: BLE001 - breaker, re-raised
            # once per REQUEST, not per waiter: two hedged waiters share
            # one dedup'd future
            with state.cond:
                noted, request.breaker_noted = request.breaker_noted, True
            if not noted:
                self._breaker_note(state, e, is_probe=request.is_probe)
            raise
        if isinstance(out, _ReplayInline):
            # handed back by the coalescer (solo drained window, or a
            # failed super-batch split): run the model's own chunked
            # path HERE, on the requester's thread
            try:
                with self._breaker_observe(state,
                                           is_probe=request.is_probe):
                    return self._replay_alone(state, request)
            finally:
                with state.cond:
                    state.note_latency(time.monotonic() - t0)
        try:
            host = _fetch(*out)
        except Exception as e:  # noqa: BLE001 - classified, then replayed
            kind = resilience.classify(e)
            if kind == resilience.FATAL:
                raise
            if kind == resilience.OOM:
                health.record(health.OOM_RECHUNK, rows=request.rows,
                              at="fetch")
            logger.warning(
                "coalesced result fetch failed (%s: %s; classified %s); "
                "re-running the %d-row request alone", type(e).__name__,
                e, kind, request.rows)
            with self._breaker_observe(state, is_probe=request.is_probe,
                                       note_success=False):
                host = self._replay_alone(state, request)
        self._breaker_note(state, None, is_probe=request.is_probe)
        with state.cond:
            state.note_latency(time.monotonic() - t0)
        return host

    # -- state / thread management -------------------------------------------

    def _state(self, fn: Any, model: Any, batch_size: int,
               device: torch.device) -> _FnState:
        key = (id(fn), batch_size)
        with self._lock:
            state = self._states.get(key)
            if state is None or state.fn is not fn:
                self._sweep_stale_locked()
                state = _FnState(key, fn, model, batch_size, device)
                self._states[key] = state
            state.last_used = time.monotonic()
            return state

    def _retire_locked(self, state: _FnState, now: float) -> None:
        """Drop a fully-quiesced idle state from the registry — the ONE
        definition of the retirement invariant, shared by the coalescer's
        idle exit and the opportunistic new-state sweep. BOTH state.cond
        and self._lock must be held."""
        if (not state.pending and state.inflight == 0
                and state.thread is None
                and now - state.last_used >= _idle_exit_s()
                and self._states.get(state.key) is state):
            del self._states[state.key]

    def _sweep_stale_locked(self) -> None:
        """Drop idle states so the service never pins a discarded model's
        weights for the process lifetime (model churn: CrossValidator,
        notebooks). Called with self._lock held, on the rare new-state
        path; a state's cond is only probed non-blocking — the canonical
        lock order is cond→lock, so blocking here could deadlock."""
        now = time.monotonic()
        for state in list(self._states.values()):
            if now - state.last_used < _idle_exit_s():
                continue
            if not state.cond.acquire(blocking=False):
                continue  # busy: next sweep gets it
            try:
                self._retire_locked(state, now)
            finally:
                state.cond.release()

    def retire_model(self, model: Any, variants: Optional[list] = None
                     ) -> int:
        """The serving residency manager's eviction hook: drop every idle
        coalescing state whose strong reference pins ``model`` or one of
        its memoized ``variants`` (a precision, resize or flatten variant
        is a distinct program with its own state). Busy states (queued or
        in-flight work) are skipped: their requests complete, and the idle
        sweep retires them afterwards. A dropped state's parked coalescer
        is woken and exits. Returns the number of states dropped."""
        idents = {id(m) for m in (variants or [model])}
        idents.add(id(model))
        with self._lock:
            victims = [s for s in self._states.values()
                       if id(s.model) in idents]
        dropped = 0
        for state in victims:
            with state.cond:  # canonical lock order: cond -> lock
                if state.pending or state.inflight:
                    continue
                with self._lock:
                    if self._states.get(state.key) is state:
                        del self._states[state.key]
                        dropped += 1
                state.retired = True
                state.cond.notify_all()  # the parked coalescer exits
        return dropped

    def _ensure_thread(self, state: _FnState) -> None:
        # caller holds state.cond
        if state.thread is not None and state.thread.is_alive():
            return
        with self._lock:
            self._thread_seq += 1
            seq = self._thread_seq
        state.thread = threading.Thread(
            target=self._coalescer_main, args=(state,),
            name=f"sparkdl-exec-{seq}", daemon=True)
        state.thread.start()

    def _note_inflight(self, delta: int) -> None:
        """O(1) process-wide in-flight accounting feeding the occupancy
        gauge (no cross-state sums on the per-request hot path)."""
        with self._lock:
            self._inflight_total += delta
            total = self._inflight_total
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_EXECUTOR_OCCUPANCY, total)

    def _note_queued(self, delta: int) -> None:
        """O(1) process-wide queued-request accounting (queue-depth gauge)."""
        with self._lock:
            self._queued_total += delta
            total = self._queued_total
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_EXECUTOR_QUEUE_DEPTH, total)

    def _note_admitted(self) -> None:
        with self._lock:
            self._admitted += 1
        self._note_shed_rate()

    def _note_shed(self, rows: int, priority: str, reason: str,
                   tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            self._shed += 1
        health.record(health.EXECUTOR_SHED, rows=rows, priority=priority,
                      reason=reason, tenant=tenant)
        self._note_shed_rate()

    def _note_shed_rate(self) -> None:
        if telemetry.active() is None:
            return
        with self._lock:
            admitted, shed = self._admitted, self._shed
        if admitted + shed:
            telemetry.gauge_set(telemetry.M_EXECUTOR_SHED_RATE,
                                shed / (admitted + shed))

    # -- admission control ----------------------------------------------------

    def _admit_locked(self, state: _FnState, rows: int, priority: str,
                      deadline: Optional[resilience.Deadline],
                      tenant: str = DEFAULT_TENANT) -> None:
        """Enforce the per-fn queue bound (caller holds state.cond).

        Over the bound, shed mode fails fast (interactive first displaces
        the newest queued bulk request — bulk sheds before interactive);
        block mode waits with backpressure, bounded by the caller's
        deadline and woken by every coalescer drain. An empty queue
        always admits: a bound smaller than one request must not wedge."""
        ov = state.overload

        def over() -> bool:
            if not state.pending:
                return False
            if (ov.max_queued_requests is not None
                    and len(state.pending) >= ov.max_queued_requests):
                return True
            return (ov.max_queued_rows is not None
                    and state.pending_rows + rows > ov.max_queued_rows)

        while over():
            if ov.shed:
                if (priority == PRIORITY_INTERACTIVE
                        and self._evict_bulk_locked(state)):
                    continue  # re-check: the eviction may have made room
                self._note_shed(rows, priority, reason="admission",
                                tenant=tenant)
                raise ExecutorOverloaded(
                    f"executor queue for {getattr(state.model, 'name', '?')} "
                    f"is full ({len(state.pending)} request(s), "
                    f"{state.pending_rows} row(s) queued); {rows}-row "
                    f"{priority} request shed")
            # block with backpressure: bounded by the caller's deadline
            if self._closed:
                raise ExecutorShutdown(
                    "device execution service shut down while this "
                    "request waited for admission")
            timeout = _ADMIT_WAIT_TICK_S
            if deadline is not None:
                remaining = deadline.remaining()
                if remaining <= 0:
                    health.record(health.EXECUTOR_DEADLINE_SHED,
                                  rows=rows, priority=priority,
                                  at="backpressure")
                    raise resilience.DeadlineExceeded(
                        f"request deadline ({deadline.timeout_s}s) expired "
                        "while blocked on executor admission")
                timeout = min(timeout, remaining)
            state.cond.wait(timeout=timeout)
            if self._closed:
                raise ExecutorShutdown(
                    "device execution service shut down while this "
                    "request waited for admission")

    def _evict_bulk_locked(self, state: _FnState) -> bool:
        """Shed the NEWEST queued bulk request to make room for an
        interactive arrival (caller holds state.cond). Newest-first keeps
        the displaced work's retry cheapest: it waited least, so the
        least queue progress is thrown away. Returns True if one was
        evicted."""
        for r in reversed(state.pending):
            if r.priority != PRIORITY_BULK or r.future.done():
                continue
            state.pending.remove(r)
            state.pending_rows -= r.rows
            if r.deadline is not None:
                state.pending_deadlines -= 1
            if r.token is not None and state.dedup.get(r.token) is r:
                del state.dedup[r.token]
            self._note_queued(-1)
            self._note_shed(r.rows, r.priority, reason="displaced",
                            tenant=r.tenant)
            r.future.set_exception(ExecutorOverloaded(
                f"{r.rows}-row bulk request displaced from the full "
                f"executor queue by an interactive arrival"))
            return True
        return False

    # -- per-model circuit breaker --------------------------------------------

    def _breaker_admit_locked(self, state: _FnState) -> bool:
        """Gate a submit on the breaker state (caller holds state.cond).
        Returns True when THIS request is the half-open probe. Raises
        :class:`ExecutorCircuitOpen` (RETRYABLE) while open or while a
        probe is already in flight."""
        ov = state.overload
        if ov.breaker_threshold <= 0 or state.breaker_state == "closed":
            return False
        name = getattr(state.model, "name", "?")
        if state.breaker_state == "open":
            if (time.monotonic() - state.breaker_opened_at
                    < ov.breaker_cooldown_s):
                raise ExecutorCircuitOpen(
                    f"circuit breaker for model {name!r} is open "
                    f"({ov.breaker_threshold} terminal launch failure(s) "
                    f"within {ov.breaker_window_s}s); failing fast for "
                    f"{ov.breaker_cooldown_s}s")
            state.breaker_state = "half_open"
            state.breaker_probe_inflight = True
            health.record(health.BREAKER_PROBE, model=name)
            logger.warning(
                "circuit breaker for model %r half-open after %.2fs "
                "cooldown; admitting one probe request", name,
                ov.breaker_cooldown_s)
            return True
        # half_open: exactly one probe at a time
        if state.breaker_probe_inflight:
            raise ExecutorCircuitOpen(
                f"circuit breaker for model {name!r} is half-open with a "
                "probe in flight; failing fast")
        state.breaker_probe_inflight = True
        health.record(health.BREAKER_PROBE, model=name)
        return True

    @contextmanager
    def _breaker_observe(self, state: _FnState, *, is_probe: bool = False,
                         note_success: bool = True):
        """The single home for launch-outcome breaker accounting: feed
        the wrapped block's exception (re-raised) or success into
        :meth:`_breaker_note`. ``note_success=False`` for blocks whose
        success is noted later on a shared exit path (``_await``'s fetch
        chain ends in one success note)."""
        try:
            yield
        except BaseException as e:  # noqa: BLE001 - breaker, re-raised
            self._breaker_note(state, e, is_probe=is_probe)
            raise
        else:
            if note_success:
                self._breaker_note(state, None, is_probe=is_probe)

    def _breaker_note(self, state: _FnState,
                      error: Optional[BaseException], *,
                      is_probe: bool = False) -> None:
        """Feed one terminal launch outcome into the breaker. Failures
        that never reached the device (shed, shutdown, fast-fail,
        deadline — slowness, not poison) do not count — but a PROBE that
        dies that way must still release the probe slot (back to
        half-open-with-no-probe, so the next arrival probes), or the
        breaker would wedge half-open and fail fast forever."""
        if state.overload.breaker_threshold <= 0 and not is_probe:
            return  # breaker disabled: no lock on the hot path
        if isinstance(error, (ExecutorShutdown, ExecutorOverloaded,
                              ExecutorCircuitOpen,
                              resilience.DeadlineExceeded)):
            if is_probe:
                with state.cond:
                    if state.breaker_state == "half_open":
                        state.breaker_probe_inflight = False
            return
        with state.cond:
            ov = state.overload
            if ov.breaker_threshold <= 0:
                # knobs flipped to disabled mid-flight: still release a
                # probe slot so a later re-enable can't find it wedged
                if is_probe and state.breaker_state == "half_open":
                    state.breaker_probe_inflight = False
                return
            name = getattr(state.model, "name", "?")
            now = time.monotonic()
            if state.breaker_state == "half_open":
                if not is_probe:
                    # a stale pre-trip launch resolving late must not
                    # decide the probe's verdict ("exactly one probe; ITS
                    # outcome decides"): a stale failure joins the
                    # rolling window (cleared on recovery), a stale
                    # success is ignored
                    if error is not None:
                        state.breaker_failures.append(now)
                    return
                state.breaker_probe_inflight = False
                if error is None:
                    state.breaker_state = "closed"
                    state.breaker_failures.clear()
                    health.record(health.BREAKER_CLOSED, model=name)
                    logger.warning(
                        "circuit breaker for model %r closed: probe "
                        "launch succeeded", name)
                else:
                    state.breaker_state = "open"
                    state.breaker_opened_at = now
                    health.record(health.BREAKER_OPEN, model=name,
                                  probe=True, error=type(error).__name__)
                    logger.warning(
                        "circuit breaker for model %r re-opened: probe "
                        "failed (%s: %s)", name, type(error).__name__,
                        error)
                return
            if error is None or state.breaker_state == "open":
                return
            # closed + terminal failure: count within the rolling window
            state.breaker_failures.append(now)
            cutoff = now - ov.breaker_window_s
            while (state.breaker_failures
                    and state.breaker_failures[0] < cutoff):
                state.breaker_failures.popleft()
            if len(state.breaker_failures) >= ov.breaker_threshold:
                state.breaker_state = "open"
                state.breaker_opened_at = now
                state.breaker_probe_inflight = False
                health.record(health.BREAKER_OPEN, model=name,
                              failures=len(state.breaker_failures),
                              error=type(error).__name__)
                logger.error(
                    "circuit breaker for model %r OPEN: %d terminal "
                    "launch failure(s) within %.1fs (last: %s: %s); "
                    "failing fast for %.2fs", name,
                    len(state.breaker_failures), ov.breaker_window_s,
                    type(error).__name__, error, ov.breaker_cooldown_s)

    # -- the coalescer -------------------------------------------------------

    def _coalescer_main(self, state: _FnState) -> None:
        """The coalescer thread: its device pinned to the state's (the
        current device is per thread) and inference mode entered (also
        per thread), around :meth:`_coalesce_loop`; its staging rings go
        back to the shared pool when it exits."""
        try:
            with contextlib.ExitStack() as stack:
                if state.device.type == "cuda":
                    stack.enter_context(torch.cuda.device(state.device))
                stack.enter_context(torch.inference_mode())
                self._coalesce_loop(state)
        finally:
            with state.cond:
                rings = list(state.rings.values())
                state.rings.clear()
            for ring in rings:
                batching._give_ring(ring)

    def _coalesce_loop(self, state: _FnState) -> None:
        # `crashed` guards the terminal fail-pending: an IDLE exit hands
        # the (empty) queue back cleanly — failing in that window could
        # race a fresh submit that already started a successor thread.
        crashed = True
        try:
            while True:
                with state.cond:
                    idle_since = time.monotonic()
                    while (not state.pending and not self._closed
                           and not state.retired):
                        state.cond.wait(timeout=_idle_exit_s())
                        if state.retired:
                            break
                        if (not state.pending and not self._closed
                                and time.monotonic() - idle_since
                                >= _idle_exit_s()):
                            state.thread = None
                            crashed = False
                            # retire the whole state with the thread so
                            # an abandoned model's weights don't stay
                            # pinned — unless the inline fast path is
                            # still using it (fresh last_used)
                            with self._lock:
                                self._retire_locked(state,
                                                    time.monotonic())
                            return
                    if self._closed:
                        crashed = False
                        return
                    if state.retired and not state.pending:
                        # evicted through retire_model with nothing
                        # queued: exit now rather than at the idle
                        # timeout, so the state's strong model reference
                        # dies with the thread. A submit that raced the
                        # eviction and queued anyway is drained first.
                        state.thread = None
                        crashed = False
                        return
                    # bounded wait window, anchored at the head request's
                    # arrival: late siblings join until the window closes
                    # or the bucket cap is reached
                    deadline = (state.pending[0].t_enqueue
                                + state.effective_window())
                    while not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or state.pending_rows >= state.cap:
                            break
                        if state.pending_deadlines:
                            # the earliest queued request deadline caps
                            # the wait: a doomed request triggers a drain
                            # (which drops it) the moment it expires,
                            # instead of blocking its caller for the
                            # remainder of a possibly much longer window
                            for r in state.pending:
                                if r.deadline is not None:
                                    remaining = min(remaining,
                                                    r.deadline.remaining())
                            if remaining <= 0:
                                break
                        state.cond.wait(timeout=remaining)
                    if self._closed:
                        crashed = False
                        return
                    batch: List[_Request] = []
                    expired: List[_Request] = []
                    total = 0
                    # ONE O(n) pass: drop already-expired requests BEFORE
                    # paying for a launch (an overloaded queue must not
                    # turn one slow window into a convoy of doomed
                    # launches) and partition survivors into lanes —
                    # never per-item deque.remove(), which would make a
                    # deep drain O(n^2) exactly when the queue is deep
                    lanes: Dict[str, Dict[str, List[_Request]]] = \
                        {p: {} for p in PRIORITIES}
                    for r in state.pending:
                        if r.deadline is not None and r.deadline.expired():
                            if (r.token is not None
                                    and state.dedup.get(r.token) is r):
                                del state.dedup[r.token]
                            expired.append(r)
                        else:
                            lanes[r.priority].setdefault(
                                r.tenant, []).append(r)
                    # interactive lane drains first; within a lane, one
                    # tenant is plain FIFO (the pre-fairness fast path,
                    # byte-identical release order) and several tenants
                    # release by deficit-round-robin — a flooding tenant
                    # saturates only its weighted share of the cap
                    overflow = False
                    throttled: List[str] = []
                    for lane in PRIORITIES:
                        if overflow:
                            break
                        queues = lanes[lane]
                        if not queues:
                            continue
                        if len(queues) == 1:
                            (reqs,) = queues.values()
                            for r in reqs:
                                if batch and total + r.rows > state.cap:
                                    overflow = True
                                    break
                                r.launched = True  # past dedup sharing
                                batch.append(r)
                                total += r.rows
                            continue
                        total, overflow = self._drr_release_locked(
                            state, queues, batch, total, throttled)
                    if throttled and batch:
                        for tenant in sorted(set(throttled)):
                            health.record(
                                health.TENANT_THROTTLED, tenant=tenant,
                                released_rows=total)
                    if batch or expired:
                        dropped = {id(r) for r in batch}
                        dropped.update(id(r) for r in expired)
                        # rebuild preserves arrival order for leftovers
                        state.pending = deque(
                            r for r in state.pending
                            if id(r) not in dropped)
                        state.pending_rows -= (
                            total + sum(r.rows for r in expired))
                        state.pending_deadlines = sum(
                            1 for r in state.pending
                            if r.deadline is not None)
                        self._note_queued(-(len(batch) + len(expired)))
                        # blocked admission waiters: room just freed
                        state.cond.notify_all()
                    if batch:
                        state.inflight += 1
                        self._note_inflight(1)
                if expired:
                    self._fail_expired(expired)
                if not batch:
                    continue  # the whole window expired unlaunched
                try:
                    self._launch(state, batch, total)
                except BaseException as e:  # noqa: BLE001 - delivered below
                    # a failure in the launch plumbing itself (concat,
                    # slicing) must still complete every drained future —
                    # the batch already left `pending`, so the terminal
                    # fail-pending sweep would miss it
                    logger.exception(
                        "coalescer launch plumbing failed; delivering the "
                        "error to all %d drained request(s)", len(batch))
                    # ONE failed launch = ONE breaker count, however many
                    # requests the window held; mark every member so the
                    # waiters' fetch-side accounting doesn't re-count it
                    with state.cond:
                        for r in batch:
                            r.breaker_noted = True
                    self._breaker_note(
                        state, e,
                        is_probe=any(r.is_probe for r in batch))
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                finally:
                    with state.cond:
                        state.inflight -= 1
                        for r in batch:
                            if (r.token is not None
                                    and state.dedup.get(r.token) is r):
                                del state.dedup[r.token]
                        self._note_inflight(-1)
        finally:
            if crashed or self._closed:
                self._fail_pending(state,
                                   ExecutorShutdown(
                                       "device execution service shut "
                                       "down with this request still "
                                       "queued"))

    def _drr_release_locked(self, state: _FnState,
                            queues: Dict[str, List[_Request]],
                            batch: List[_Request], total: int,
                            throttled: List[str]) -> Tuple[int, bool]:
        """Release one lane's queued requests by deficit-round-robin
        (caller holds ``state.cond``). Each round credits every tenant
        ``weight * quantum`` rows (quantum = the largest head-of-line
        request, so every tenant frees at least its head per round — the
        loop is O(requests) releases, never stuck), then releases that
        tenant's FIFO while the credit covers it. The first over-cap
        head stops the whole drain (same overflow contract as the FIFO
        path); credit persists across drains for tenants left queued —
        that deficit IS the fairness memory — and resets once a tenant
        drains dry, so idle tenants never bank unbounded credit.
        Tenants left holding requests while the batch launched are
        appended to ``throttled``. Returns ``(total, overflow)``."""
        weights = state.tenant_weights or {}
        deficit = state.tenant_deficit
        order = sorted(queues)
        overflow = False
        while not overflow and any(queues[t] for t in order):
            quantum = max(float(queues[t][0].rows)
                          for t in order if queues[t])
            for tenant in order:
                fifo = queues[tenant]
                if not fifo:
                    continue
                deficit[tenant] = (deficit.get(tenant, 0.0)
                                   + max(1, weights.get(tenant, 1))
                                   * quantum)
                while fifo and deficit[tenant] >= fifo[0].rows:
                    r = fifo[0]
                    if batch and total + r.rows > state.cap:
                        overflow = True
                        break
                    fifo.pop(0)
                    deficit[tenant] -= r.rows
                    r.launched = True  # past the dedup sharing window
                    batch.append(r)
                    total += r.rows
                if overflow:
                    break
        for tenant in order:
            if not queues[tenant]:
                deficit.pop(tenant, None)
            else:
                throttled.append(tenant)
        return total, overflow

    def _fail_expired(self, expired: List[_Request]) -> None:
        """Deliver the deadline-shed outcome: the same deadline-marked
        taxonomy the supervisor's watchdog uses (``DeadlineExceeded`` →
        FATAL, never retried past the budget, never quarantined)."""
        for r in expired:
            health.record(health.EXECUTOR_DEADLINE_SHED, rows=r.rows,
                          priority=r.priority, tenant=r.tenant,
                          queued_s=round(time.monotonic() - r.t_enqueue, 4))
            if not r.future.done():
                r.future.set_exception(resilience.DeadlineExceeded(
                    f"{r.rows}-row request expired in the executor queue "
                    f"(deadline {r.deadline.timeout_s}s); dropped before "
                    "launch"))

    def _fail_pending(self, state: _FnState, error: BaseException) -> None:
        with state.cond:
            pending = list(state.pending)
            state.pending.clear()
            state.pending_rows = 0
            state.pending_deadlines = 0
            state.dedup.clear()
            if state.thread is threading.current_thread():
                state.thread = None
            state.cond.notify_all()  # blocked admission waiters re-check
        if pending:
            self._note_queued(-len(pending))
        for r in pending:
            if not r.future.done():
                r.future.set_exception(error)

    def _launch(self, state: _FnState, batch: List[_Request],
                total_rows: int) -> None:
        """Dispatch one drained window. Requests are grouped by element
        signature first — one program serves several shapes (one graph
        per shape), and rows only concatenate within a shape. A group of
        one is handed back to run inline on its requester's thread;
        larger groups concatenate into one padded launch whose outputs
        are sliced back per request ON THE DEVICE. A handed-back request
        gets the replay sentinel, so the REQUESTER'S thread runs the
        model's own chunked path in `_await` (its classified retry and
        OOM re-chunk apply unchanged), and the requests of a split window
        replay concurrently on their own pool threads instead of
        serializing through the coalescer. Every future is delivered
        after the window's launch time is recorded: a requester that
        tears its telemetry scope down the moment its result arrives
        still finds it."""
        t0 = time.monotonic()
        now = t0
        for r in batch:
            telemetry.observe(telemetry.M_QUEUE_WAIT_S, now - r.t_enqueue)
            if r.tenant != DEFAULT_TENANT:
                # per-tenant fairness series (per-tenant NAMES — metrics
                # carry no labels); the default tenant stays on the
                # aggregate only, so single-tenant jobs add no series
                telemetry.observe(
                    telemetry.declare_metric(
                        telemetry.tenant_queue_wait_metric(r.tenant),
                        "histogram"),
                    now - r.t_enqueue)
        groups: Dict[Tuple, List[_Request]] = {}
        for r in batch:
            groups.setdefault(batching.element_signature(r.tree),
                              []).append(r)
        results: List[Tuple[_Request, Any]] = []
        for signature, group in groups.items():
            rows = sum(r.rows for r in group)
            telemetry.observe(telemetry.M_COALESCE_REQUESTS, len(group),
                              bounds=telemetry.POW2_BOUNDS)
            telemetry.observe(telemetry.M_COALESCE_ROWS, rows,
                              bounds=telemetry.POW2_BOUNDS)
            if len(group) == 1:
                results.append((group[0], _REPLAY_INLINE))
            else:
                results.extend(self._run_coalesced(state, group, rows,
                                                   signature))
        telemetry.observe(telemetry.M_LAUNCH_S, time.monotonic() - t0)
        for r, result in results:
            if not r.future.done():
                r.future.set_result(result)

    def _stage(self, state: _FnState, batch: List[_Request], bucket: int,
               signature: Tuple) -> Tuple[Optional[int], Any, torch.Tensor]:
        """The window's rows, concatenated in submission order and padded
        to ``bucket``: on the card into a slot of the coalescer's pinned
        ring (an upload from pageable memory would be a synchronous
        staged copy), on the CPU into a fresh array. Returns (slot, ring,
        chunk)."""
        parts = [r.tree for r in batch]
        if state.device.type != "cuda":
            padded, _ = batching.pad_batch(np.concatenate(parts, axis=0),
                                           bucket)
            return None, None, torch.from_numpy(padded)
        ring = state.rings.get(signature)
        if ring is None:
            shape = (state.batch_size,) + tuple(parts[0].shape[1:])
            ring = batching._take_ring(
                0, shape, torch.from_numpy(parts[0][:0]).dtype)
            state.rings[signature] = ring
        ring.reclaim()
        slot, chunk = ring.stage_parts(parts, bucket)
        return slot, ring, chunk

    def _run_coalesced(self, state: _FnState, batch: List[_Request],
                       total_rows: int, signature: Tuple
                       ) -> List[Tuple[_Request, Any]]:
        """One padded launch of ``batch``'s rows; returns each request's
        result for `_launch` to deliver: its rows sliced on the device
        and the event recorded after them, or, when the launch failed,
        the replay sentinel."""
        failure: Optional[Exception] = None
        slices: List[torch.Tensor] = []
        done: Any = None
        # The span closes BEFORE any future is delivered: a requester that
        # tears its telemetry scope down the moment its result arrives
        # still finds the launch span recorded.
        with telemetry.span(telemetry.SPAN_COALESCED_LAUNCH,
                            parent=batch[0].ctx,
                            requests=len(batch), rows=total_rows):
            planner = state.planner
            if planner is not None:
                # the coalesced launch stream feeds the same learned
                # ladder as the chunked path; a cap tighter than the
                # planner's batch_size falls back to pow2 inside
                planner.observe(total_rows)
                bucket = planner.bucket_for(total_rows, cap=state.cap)
            else:
                bucket = batching.bucket_size(total_rows, state.cap)
            # the HEAD request's policy decides whether a transient
            # counts as a retry for accounting; the actual retries run
            # per request under each request's OWN policy (the replay
            # sentinel returned below) — never as a backoff sleep on the
            # coalescer thread
            policy = batch[0].policy
            try:
                resilience.inject("device_oom", rows=bucket,
                                  valid=total_rows)
                resilience.inject("transfer_stall", rows=bucket,
                                  valid=total_rows)
                slot, ring, chunk = self._stage(state, batch, bucket,
                                                signature)
                try:
                    out = state.fn(chunk, total_rows)
                finally:
                    if ring is not None:
                        ring.retire(slot, torch.cuda.current_stream(
                            state.device))
            except Exception as e:  # noqa: BLE001 - classified below
                kind = resilience.classify(e)
                if kind == resilience.OOM:
                    health.record(health.OOM_RECHUNK, bucket=bucket,
                                  requests=len(batch))
                elif (kind == resilience.RETRYABLE
                        and policy.max_retries > 0):
                    # CHUNK_RETRY parity with the chunk path: the failed
                    # super-batch IS retried — per request, on the
                    # requesters' own threads via the replay sentinel
                    health.record(health.CHUNK_RETRY, bucket=bucket,
                                  attempt=1, error=type(e).__name__)
                failure = e
            else:
                off = 0
                for r in batch:
                    slices.append(out[off:off + r.rows])
                    off += r.rows
                if out.is_cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(state.device))
        if failure is not None:
            # ANY super-batch failure splits back into per-request
            # sub-launches on the requesters' own threads, on the card,
            # through the same graphs: a transient retries there under
            # each request's policy, an OOM re-chunks exactly as the
            # non-coalesced path would, a FATAL poisons only its own
            # request instead of the whole window.
            logger.warning(
                "coalesced launch of %d request(s) failed (%s: %s); "
                "splitting back to per-request sub-launches",
                len(batch), type(failure).__name__, failure)
            return [(r, _REPLAY_INLINE) for r in batch]
        return [(r, (sliced, done)) for r, sliced in zip(batch, slices)]

    # -- introspection -------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """Instantaneous queue/breaker state. Lock order honored:
        ``self._lock`` is released before any state's cond is taken
        (canonical order is cond→lock)."""
        with self._lock:
            states = list(self._states.values())
            out: Dict[str, Any] = {
                "closed": self._closed,
                "queued_requests": self._queued_total,
                "inflight": self._inflight_total,
                "admitted": self._admitted,
                "shed": self._shed,
            }
        models = []
        for state in states:
            with state.cond:
                models.append({
                    "model": getattr(state.model, "name", "?"),
                    "pending_requests": len(state.pending),
                    "pending_rows": state.pending_rows,
                    "inflight": state.inflight,
                    "breaker_state": state.breaker_state,
                })
        out["models"] = models
        return out

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        """Stop every coalescer thread; fail every queued request with
        :class:`ExecutorShutdown`. In-flight launches complete. No future
        is ever left pending.

        Idempotent and safe to race with concurrent :meth:`submit` calls:
        a second shutdown is a no-op, and a submit that loses the race
        observes ``_closed`` under its state's cond (``_closed`` is
        published under ``self._lock``, which every state lookup also
        takes) and raises — a request can never be queued after its
        state's pending sweep ran without the sweep seeing it."""
        with self._lock:
            if self._shutdown_complete:
                return  # double-shutdown: a no-op
            self._closed = True
            states = list(self._states.values())
        err = ExecutorShutdown("device execution service shut down with "
                               "this request still queued")
        for state in states:
            with state.cond:
                state.cond.notify_all()
                thread = state.thread
            if thread is not None and thread is not threading.current_thread():
                thread.join(timeout=5.0)
            self._fail_pending(state, err)
        with self._lock:
            self._shutdown_complete = True


# ---------------------------------------------------------------------------
# Module-level service + the choke point
# ---------------------------------------------------------------------------

_service = DeviceExecutor()
_service_lock = threading.Lock()


def service() -> DeviceExecutor:
    return _service


def shutdown() -> None:
    """Shut the process-wide service down (fails queued requests)."""
    _service.shutdown()


def status() -> Dict[str, Any]:
    """Queue/breaker state of the process-wide service."""
    return _service.status()


def reset() -> DeviceExecutor:
    """Shut down and replace the process-wide service (test isolation)."""
    global _service
    with _service_lock:
        old = _service
        _service = DeviceExecutor()
    old.shutdown()
    return _service


def resolve_device() -> torch.device:
    """``EngineConfig.device`` as a torch device. The default is the card;
    asking for it without one raises — the featurize path never falls
    back to the CPU on its own."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    device = torch.device(EngineConfig.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device is {EngineConfig.device!r} but CUDA is not "
            "available (torch.cuda.is_available() is False); set "
            "EngineConfig.device = 'cpu' to run the plain PyTorch versions "
            "on the CPU")
    return device


def _fetch(out: torch.Tensor, done: Any) -> np.ndarray:
    """The requester's one device-to-host copy of its rows: its stream
    first waits on the event recorded after the coalescer's slices (the
    current stream is per thread), and the rows' memory is marked in use
    by that stream until the copy is done."""
    if done is not None:
        stream = torch.cuda.current_stream(out.device)
        stream.wait_event(done)
        out.record_stream(stream)
    if out.dtype == torch.bfloat16:  # numpy has no bfloat16
        out = out.float()
    return out.cpu().numpy()


def _payload_bytes(obj: Any) -> int:
    """The bytes of every array leaf of ``obj`` (an array, or a tuple,
    list or dict of them): the reference's count, summed over the leaves
    of its payload; a leaf without ``nbytes`` counts 0."""
    if isinstance(obj, dict):
        return sum(_payload_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_payload_bytes(v) for v in obj)
    return int(getattr(obj, "nbytes", 0) or 0)


def execute(model: Any, array: Any, *, batch_size: int = 64,
            retry_policy: Optional[resilience.RetryPolicy] = None,
            prefetch: int = 2, coalesce: Optional[bool] = None,
            priority: Optional[str] = None,
            deadline: Optional[resilience.Deadline] = None,
            tenant: Optional[str] = None,
            coalesce_window_ms: Optional[float] = None) -> np.ndarray:
    """THE device entry point for the inference data plane; returns numpy.

    Decides, once, the precision (``EngineConfig.inference_precision``,
    applied through ``ModelFunction.with_dtype``) and the device
    (:func:`resolve_device`). With ``EngineConfig.coalesce`` on (the
    default), eligible requests — non-empty, at most one bucket's worth of
    rows — route through the coalescing service; everything else (and
    ``coalesce=False``) takes ``apply_batch`` unchanged. ``coalesce=None``
    reads ``EngineConfig.coalesce``.

    ``priority`` (``"interactive"``/``"bulk"``; ``None`` reads
    ``EngineConfig.executor_default_priority``) picks the service lane;
    ``deadline`` (``None`` adopts the ambient :class:`deadline_scope`
    one, which the engine supervisor threads per task) bounds queue wait
    and backpressure blocking. ``tenant`` tags the request for the
    fair-queueing coalescer (``None`` adopts the ambient
    :class:`tenant_scope` tag, falling back to
    ``EngineConfig.executor_default_tenant``). ``prefetch``: chunk
    staging depth of ``apply_batch``'s async input pipeline (0 = inline).
    ``coalesce_window_ms`` overrides ``EngineConfig.coalesce_window_ms``
    for THIS call. The reference's ``mesh`` argument is not ported yet.
    """
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    EngineConfig.validate()  # read-time knob validation (clear ValueError)
    device = resolve_device()
    pinned = contextlib.nullcontext()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # the current device is per thread: pin this call's on its thread
        # (a partition thread), so the model, its graphs, the staging ring
        # and the coalescer all see one device
        pinned = torch.cuda.device(device)
    if telemetry.active() is not None:
        # the input as the caller gave it, before any staging cast: raw
        # uint8 pixels on the image path, as the reference counts
        payload = _payload_bytes(array)
        if payload:
            telemetry.count(telemetry.M_STAGED_BYTES, payload)
    with pinned:
        array = model.stage_inputs(array)
        if EngineConfig.inference_precision != "float32":
            model = model.with_dtype(EngineConfig.inference_precision)
        planner = batching.default_planner(getattr(model, "name", "model"),
                                           batch_size)
        if coalesce is None:
            coalesce = EngineConfig.coalesce
        cap = batch_size
        if EngineConfig.coalesce_max_rows is not None:
            cap = min(cap, int(EngineConfig.coalesce_max_rows))
        rows = array.shape[0]
        if not coalesce or rows == 0 or rows > cap:
            # nothing to coalesce (empty partitions hit the memoized empty
            # template) / already a full bucket or more: chunked path
            return model.apply_batch(array, batch_size=batch_size,
                                     device=device, retry_policy=retry_policy,
                                     prefetch=prefetch, planner=planner)
        window_ms = (coalesce_window_ms if coalesce_window_ms is not None
                     else EngineConfig.coalesce_window_ms)
        window_s = None if window_ms is None else max(0.0, window_ms / 1e3)
        policy = (retry_policy if retry_policy is not None
                  else resilience.DEFAULT_INFERENCE_POLICY)
        if (EngineConfig.executor_max_queued_requests is None
                and EngineConfig.executor_max_queued_rows is None
                and EngineConfig.executor_breaker_threshold <= 0):
            overload = _NO_OVERLOAD  # defaults: no per-call allocation
        else:
            overload = OverloadPolicy(
                max_queued_requests=EngineConfig.executor_max_queued_requests,
                max_queued_rows=EngineConfig.executor_max_queued_rows,
                shed=EngineConfig.executor_overload_mode == "shed",
                breaker_threshold=EngineConfig.executor_breaker_threshold,
                breaker_window_s=EngineConfig.executor_breaker_window_s,
                breaker_cooldown_s=EngineConfig.executor_breaker_cooldown_s)
        if priority is None:
            priority = EngineConfig.executor_default_priority
        if deadline is None:
            deadline = current_deadline()
        if tenant is None:
            tenant = current_tenant()
            if tenant is None:
                tenant = EngineConfig.executor_default_tenant
        return _service.submit(model, array, rows, batch_size, device, policy,
                               window_s, cap, prefetch, priority=priority,
                               deadline=deadline, tenant=tenant,
                               tenant_weights=(
                                   EngineConfig.executor_tenant_weights),
                               overload=overload, planner=planner)
