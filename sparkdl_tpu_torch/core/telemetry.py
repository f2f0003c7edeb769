"""Telemetry's core: cross-thread span tracing, metrics, one run report.

A port of the core of ``sparkdl_tpu.core.telemetry``, in three parts:

1. **Span tracing** — a :class:`Tracer` producing per-span records (name,
   trace_id, span_id, parent_id, thread, start/end ns, attributes) into a
   bounded ring buffer, with explicit cross-thread context handoff
   (:func:`current_context` on the parent thread, ``span(parent=ctx)`` or
   :func:`attach` on the child), so a partition's spans, the prefetcher's
   staging thread and the compile of a new bucket all parent under one
   run trace. Exportable as Chrome-trace JSON.
2. **Metrics registry** — named :class:`Counter` / :class:`Gauge` /
   :class:`Histogram` instruments (fixed log-scale buckets with
   p50/p95/p99 estimates), with a JSON :meth:`MetricsRegistry.snapshot`
   and a Prometheus text-exposition dump.
3. **Run report** — :class:`RunReport` merges the trace summary, the
   metric snapshot, ``profiling.phase_stats()``/``overlap_stats()`` and
   the active ``HealthMonitor`` report into one JSON artifact written at
   scope exit (opt-in via ``SPARKDL_TELEMETRY_DIR`` or an explicit
   ``Telemetry(out_dir=...)``), and stamps ``run_id``/``trace_id`` onto
   the package's log records while the scope is active.

Spans measured in another process (a decode-pool worker, which has no
tracer of its own) cross as wire records (:func:`remote_span`, with
timestamps moved onto the parent's clock by :func:`clock_handshake`)
and are adopted with :meth:`Tracer.record_remote`; a shipped ring is
merged with :meth:`Tracer.adopt_remote_spans`. The reference's live
plane (windowed instruments, the periodic snapshot exporter and its SLO
watchdog), its ring export and its serving and tenant metric names are
not ported yet.

A :class:`Telemetry` scope activates process-wide (partition ops may run
on other threads), nests, and restores the previous scope on exit. With
no active scope every entry point — :func:`span`, :func:`count`,
:func:`gauge_set`, :func:`observe` — is one global read and a ``None``
check returning a shared singleton: the hot paths allocate nothing and
never touch the card (telemetry must never add a device sync).

Standard library only: every layer may import it without cycles.
"""

from __future__ import annotations

import bisect
import itertools
import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

TELEMETRY_DIR_ENV = "SPARKDL_TELEMETRY_DIR"

# ---------------------------------------------------------------------------
# Canonical names: the reference's values, for the spans and metrics the
# port records.
# ---------------------------------------------------------------------------

SPAN_RUN = "sparkdl.run"                      # telemetry scope root
SPAN_MATERIALIZE = "sparkdl.materialize"      # DataFrame._materialize barrier
SPAN_TASK = "sparkdl.task"                    # one pool attempt (or hedge)
SPAN_TASK_ATTEMPT = "sparkdl.task_attempt"    # one retry-loop attempt
SPAN_COMPILE = "sparkdl.compile"              # first launch of a new shape
SPAN_COALESCED_LAUNCH = "sparkdl.coalesced_launch"  # core/executor.py
SPAN_DECODE_POOL = "sparkdl.decode_pool"      # one pooled decode fan-out
                                              # (core/decode_pool.py)
SPAN_DECODE_CHUNK = "sparkdl.decode_chunk"    # one chunk decoded inside
                                              # a pool worker process
                                              # (core/decode_pool.py)

CANONICAL_SPAN_NAMES = frozenset({
    SPAN_RUN, SPAN_MATERIALIZE, SPAN_TASK, SPAN_TASK_ATTEMPT, SPAN_COMPILE,
    SPAN_COALESCED_LAUNCH, SPAN_DECODE_POOL, SPAN_DECODE_CHUNK,
    # phase names (core/profiling.py constants + literal call sites)
    "sparkdl.decode", "sparkdl.stage", "sparkdl.stage_batch",
    "sparkdl.host_stage", "sparkdl.host_resize", "sparkdl.host_wait",
    "sparkdl.device_apply", "sparkdl.device_sync",
})

# Metric catalog. Histograms in seconds use DEFAULT_TIME_BOUNDS; row-count
# histograms use POW2_BOUNDS. Health-event mirrors are dynamic:
# "sparkdl.health.<event>" per core/health.py event name, bumped in
# health.record so telemetry counters equal HealthMonitor counts exactly.
M_TASK_DURATION_S = "sparkdl.task.duration_s"          # histogram
M_PREFETCH_DEPTH = "sparkdl.prefetch.queue_depth"      # gauge
M_PREFETCH_STALL_S = "sparkdl.prefetch.stall_s"        # histogram
M_BATCH_ROWS = "sparkdl.batching.rows"                 # counter (valid rows)
M_BATCH_PAD_ROWS = "sparkdl.batching.pad_rows"         # counter (pad rows)
M_BATCH_BUCKET_ROWS = "sparkdl.batching.bucket_rows"   # histogram
M_PADDING_WASTE = "sparkdl.batching.padding_waste"     # gauge (pad fraction)
# Telemetry-tuned bucket ladder (core/batching.BucketPlanner): one counter
# bump per adopted ladder, and the planner's predicted pad fraction under
# the ladder it just adopted.
M_BUCKET_LADDER_UPDATE = "sparkdl.batching.bucket_ladder_update"  # counter
M_PLANNER_WASTE = "sparkdl.batching.planner_waste"     # gauge (pad fraction)
M_ENGINE_ROWS_OUT = "sparkdl.engine.rows_out"          # counter
M_ENGINE_BYTES_OUT = "sparkdl.engine.bytes_out"        # counter
# Device execution service (core/executor.py): the coalesced launches'
# sizes in requests and rows, the hedge dedup hits, each request's wait
# in the queue, the coalescer's host time per drained window, and the
# service's instantaneous in-flight launches, queued requests and shed
# fraction. The shed/deadline/breaker counts arrive as sparkdl.health.*
# mirrors of the core/health.py events.
M_COALESCE_REQUESTS = "sparkdl.executor.coalesce_requests"  # histogram
M_COALESCE_ROWS = "sparkdl.executor.coalesce_rows"     # histogram
M_COALESCE_DEDUP = "sparkdl.executor.dedup_hits"       # counter (hedges)
M_QUEUE_WAIT_S = "sparkdl.executor.queue_wait_s"       # histogram
M_LAUNCH_S = "sparkdl.executor.launch_s"               # histogram (host)
M_EXECUTOR_OCCUPANCY = "sparkdl.executor.occupancy"    # gauge (in-flight)
M_EXECUTOR_QUEUE_DEPTH = "sparkdl.executor.queue_depth"  # gauge (queued reqs)
M_EXECUTOR_SHED_RATE = "sparkdl.executor.shed_rate"    # gauge (shed fraction)
# Bytes handed to the executor per execute() call as staged by the host
# (raw uint8 pixels on the image path).
M_STAGED_BYTES = "sparkdl.executor.staged_bytes"       # counter
# The parallel host decode pool (core/decode_pool.py): chunks in flight,
# workers holding one, and each blob's decode time in its worker
# (chunk-amortized).
M_DECODE_POOL_DEPTH = "sparkdl.decode_pool.queue_depth"    # gauge (chunks)
M_DECODE_POOL_BUSY = "sparkdl.decode_pool.workers_busy"    # gauge
M_DECODE_POOL_DECODE_S = "sparkdl.decode_pool.decode_s"    # histogram
# The kernel gate (core/kernels.py): one histogram observation per
# audition and one adopted/rejected counter bump per settled verdict.
M_KERNEL_AUTOTUNE_S = "sparkdl.kernel.autotune_s"      # histogram
M_KERNEL_ADOPTED = "sparkdl.kernel.adopted"            # counter
M_KERNEL_REJECTED = "sparkdl.kernel.rejected"          # counter
HEALTH_METRIC_PREFIX = "sparkdl.health."

CANONICAL_METRIC_KINDS: Dict[str, str] = {
    M_TASK_DURATION_S: "histogram",
    M_PREFETCH_DEPTH: "gauge",
    M_PREFETCH_STALL_S: "histogram",
    M_BATCH_ROWS: "counter",
    M_BATCH_PAD_ROWS: "counter",
    M_BATCH_BUCKET_ROWS: "histogram",
    M_PADDING_WASTE: "gauge",
    M_BUCKET_LADDER_UPDATE: "counter",
    M_PLANNER_WASTE: "gauge",
    M_ENGINE_ROWS_OUT: "counter",
    M_ENGINE_BYTES_OUT: "counter",
    M_COALESCE_REQUESTS: "histogram",
    M_COALESCE_ROWS: "histogram",
    M_COALESCE_DEDUP: "counter",
    M_QUEUE_WAIT_S: "histogram",
    M_LAUNCH_S: "histogram",
    M_EXECUTOR_OCCUPANCY: "gauge",
    M_EXECUTOR_QUEUE_DEPTH: "gauge",
    M_EXECUTOR_SHED_RATE: "gauge",
    M_STAGED_BYTES: "counter",
    M_DECODE_POOL_DEPTH: "gauge",
    M_DECODE_POOL_BUSY: "gauge",
    M_DECODE_POOL_DECODE_S: "histogram",
    M_KERNEL_AUTOTUNE_S: "histogram",
    M_KERNEL_ADOPTED: "counter",
    M_KERNEL_REJECTED: "counter",
}

CANONICAL_METRIC_NAMES = frozenset(CANONICAL_METRIC_KINDS)

_declare_lock = threading.Lock()


def declare_metric(name: str, kind: str) -> str:
    """Declare a DYNAMIC metric name (the per-tenant queue-wait histogram)
    into the catalog. Idempotent; re-declaring with a DIFFERENT kind
    raises. Returns ``name``."""
    if kind not in ("histogram", "counter", "gauge"):
        raise ValueError(
            f"declare_metric kind must be 'histogram', 'counter' or "
            f"'gauge', got {kind!r}")
    global CANONICAL_METRIC_NAMES
    with _declare_lock:
        have = CANONICAL_METRIC_KINDS.get(name)
        if have is not None and have != kind:
            raise ValueError(
                f"metric {name!r} already declared as {have!r}, cannot "
                f"re-declare as {kind!r}")
        if have is None:
            CANONICAL_METRIC_KINDS[name] = kind
            CANONICAL_METRIC_NAMES = frozenset(CANONICAL_METRIC_KINDS)
    return name


def tenant_queue_wait_metric(tenant: str) -> str:
    """The per-tenant queue-wait histogram name: metrics carry no labels,
    so per-tenant fairness gets per-tenant NAMES, observed by the
    executor's coalescer beside the aggregate ``M_QUEUE_WAIT_S``."""
    return M_QUEUE_WAIT_S + "." + tenant

# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------


class SpanContext(NamedTuple):
    """The cross-thread handoff token: enough to parent a remote span."""

    trace_id: str
    span_id: int


class _RootSentinel:
    """``Tracer.span(parent=ROOT)``: force a parentless root span (vs
    ``parent=None``, which adopts the ambient context)."""


ROOT = _RootSentinel()


_tls = threading.local()


def _span_stack() -> List["_Span"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _NullSpan:
    """Shared no-op span: the inactive path returns THIS singleton —
    zero allocation, inert context manager."""

    __slots__ = ()
    context: Optional[SpanContext] = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set_attribute(self, key: str, value: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """An open span; records into its tracer's ring buffer on exit."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "attributes", "_start_ns", "_pushed")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: Optional[int],
                 attributes: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attributes = attributes
        self._start_ns = 0
        self._pushed = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def __enter__(self) -> "_Span":
        _span_stack().append(self)
        self._pushed = True
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_ns = time.perf_counter_ns()
        if self._pushed:
            stack = _span_stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:  # defensive: exited out of order
                stack.remove(self)
            self._pushed = False
        if exc_type is not None:
            self.attributes.setdefault("error", exc_type.__name__)
        self._tracer._record(self, self._start_ns, end_ns)
        return False


class Tracer:
    """Per-run span recorder: bounded ring buffer + Chrome-trace export.

    The ring keeps the most recent ``max_spans`` finished spans (the end
    of a run is where failures live) and counts evictions in
    :attr:`dropped`. Thread-safe; spans may finish on any thread.
    """

    def __init__(self, trace_id: str, max_spans: int = 65536) -> None:
        self.trace_id = trace_id
        self.max_spans = max_spans
        self.dropped = 0
        # spans of other processes taken in, and refused for a name
        # outside CANONICAL_SPAN_NAMES
        self.remote_adopted = 0
        self.remote_rejected = 0
        self._lock = threading.Lock()
        self._spans: "deque[Dict[str, Any]]" = deque(maxlen=max_spans)
        self._ids = itertools.count((os.getpid() << 40) | 1)
        self._t0_ns = time.perf_counter_ns()

    # -- producing -----------------------------------------------------------

    def span(self, name: str, parent: Any = None,
             **attributes: Any) -> _Span:
        """An open span context manager. ``parent`` explicitly parents a
        cross-thread span (pass the creating thread's
        :func:`current_context`); otherwise the ambient context — this
        thread's innermost open span, its attached base, or the scope
        root — is the parent. ``parent=ROOT`` makes a parentless root
        span (the scope's own run span)."""
        if parent is ROOT:
            trace_id, parent_id = self.trace_id, None
        else:
            if parent is None:
                parent = current_context()
            if parent is None:
                trace_id, parent_id = self.trace_id, None
            else:
                trace_id, parent_id = parent.trace_id, parent.span_id
        return _Span(self, name, trace_id, next(self._ids), parent_id,
                     attributes)

    def _record(self, span: _Span, start_ns: int, end_ns: int) -> None:
        thread = threading.current_thread()
        rec = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "thread_id": thread.ident,
            "thread_name": thread.name,
            "start_ns": start_ns - self._t0_ns,
            "end_ns": end_ns - self._t0_ns,
        }
        if span.attributes:
            rec["attributes"] = span.attributes
        self._append(rec)

    def _append(self, rec: Dict[str, Any], adopted: bool = False) -> None:
        with self._lock:
            if len(self._spans) == self.max_spans:
                self.dropped += 1
            self._spans.append(rec)
            self.remote_adopted += adopted

    # -- spans of other processes --------------------------------------------

    def record_remote(self, name: str, parent: Optional[SpanContext],
                      start_abs_ns: int, end_abs_ns: int, *, pid: int,
                      process: Optional[str] = None,
                      **attributes: Any) -> bool:
        """Adopt ONE span measured in another process from its wire
        record (:func:`remote_span`): the span id is allocated here (the
        remote process, a decode-pool worker, has no tracer), and the
        timestamps arrive on this process's clock already. A name outside
        :data:`CANONICAL_SPAN_NAMES` is refused and counted, not raised.
        Returns True when recorded."""
        if name not in CANONICAL_SPAN_NAMES:
            with self._lock:
                self.remote_rejected += 1
            return False
        rec: Dict[str, Any] = {
            "name": name,
            "trace_id": parent.trace_id if parent else self.trace_id,
            "span_id": next(self._ids),
            "parent_id": parent.span_id if parent else None,
            "thread_id": 0,
            "thread_name": process or f"pid-{pid}",
            "start_ns": start_abs_ns - self._t0_ns,
            "end_ns": end_abs_ns - self._t0_ns,
            "pid": pid,
        }
        if process is not None:
            rec["process"] = process
        if attributes:
            rec["attributes"] = attributes
        self._append(rec, adopted=True)
        return True

    def adopt_remote_spans(self, records: Sequence[Dict[str, Any]]
                           ) -> Tuple[int, int]:
        """Merge span records shipped from another process, their
        timestamps on this process's clock (``perf_counter_ns``), into
        this ring on its epoch, so local and remote spans share one
        timeline. A record whose name is not canonical is refused and
        counted; never raises. Returns ``(adopted, rejected)``."""
        adopted = rejected = 0
        for s in records:
            if s.get("name") not in CANONICAL_SPAN_NAMES:
                rejected += 1
                continue
            rec = dict(s)
            rec["start_ns"] = s["start_ns"] - self._t0_ns
            rec["end_ns"] = s["end_ns"] - self._t0_ns
            self._append(rec, adopted=True)
            adopted += 1
        with self._lock:
            self.remote_rejected += rejected
        return adopted, rejected

    # -- querying / export ---------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def summary(self) -> Dict[str, Any]:
        """Aggregate per-name stats over ONE snapshot of the ring."""
        spans = self.spans()
        by_name: Dict[str, Dict[str, Any]] = {}
        threads = set()
        for s in spans:
            threads.add((s["thread_id"], s["thread_name"]))
            agg = by_name.setdefault(
                s["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += (s["end_ns"] - s["start_ns"]) / 1e9
        for agg in by_name.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["mean_s"] = round(agg["total_s"] / agg["count"], 6)
        return {
            "trace_id": self.trace_id,
            "spans_recorded": len(spans),
            "spans_dropped": self.dropped,
            "remote_adopted": self.remote_adopted,
            "remote_rejected": self.remote_rejected,
            "threads": sorted(t[1] for t in threads),
            "by_name": {k: by_name[k] for k in sorted(by_name)},
        }

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace (Trace Event Format) document: complete ("X")
        events in microseconds on one track per thread, loadable by
        ``chrome://tracing`` and Perfetto. Adopted spans keep the pid of
        the process that measured them."""
        events: List[Dict[str, Any]] = []
        own = os.getpid()
        seen_threads: Dict[Tuple[int, int], str] = {}
        for s in self.spans():
            pid = s.get("pid", own)
            seen_threads.setdefault((pid, s["thread_id"]), s["thread_name"])
            events.append({
                "name": s["name"], "cat": "sparkdl", "ph": "X",
                "ts": s["start_ns"] / 1e3,
                "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                "pid": pid, "tid": s["thread_id"],
                "args": {"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"],
                         **s.get("attributes", {})},
            })
        for (pid, tid), tname in seen_threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

# Log-scale (factor-2) bucket upper bounds. Durations: 100 µs .. ~3.7 h.
DEFAULT_TIME_BOUNDS: Tuple[float, ...] = tuple(
    1e-4 * 2 ** i for i in range(27))
# Row counts / sizes: powers of two 1 .. 64Ki.
POW2_BOUNDS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(17))


def _estimate_percentile(q: float, counts: Sequence[int], count: int,
                         bounds: Sequence[float], vmin: Optional[float],
                         vmax: Optional[float]) -> Optional[float]:
    """Estimated q-quantile from ONE consistent copy of log-scale bucket
    counts: the geometric midpoint of the covering bucket, clamped to the
    observed [vmin, vmax]. ``None`` for an empty histogram."""
    if count <= 0:
        return None
    target = max(1, math.ceil(q * count))
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = (bounds[i] if i < len(bounds)
                  else (vmax if vmax is not None else lo))
            est = math.sqrt(lo * hi) if lo > 0 and hi > 0 else hi
            if vmin is not None:
                est = max(est, vmin)
            if vmax is not None:
                est = min(est, vmax)
            return est
    return vmax


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Fixed log-scale-bucket histogram with percentile estimates.

    Buckets are upper bounds (Prometheus ``le`` semantics) growing by a
    constant factor (default 2×), so the relative error of a percentile
    estimate is bounded by the factor.
    """

    __slots__ = ("name", "_lock", "bounds", "_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_TIME_BOUNDS) -> None:
        self.name = name
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            return _estimate_percentile(q, self._counts, self.count,
                                        self.bounds, self.min, self.max)

    def _raw(self) -> Tuple[Tuple[float, ...], List[int], int, float]:
        with self._lock:
            return self.bounds, list(self._counts), self.count, self.sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        buckets = {("+Inf" if i == len(self.bounds)
                    else repr(self.bounds[i])): c
                   for i, c in enumerate(counts) if c}
        return {
            "count": count, "sum": round(total, 9), "min": lo, "max": hi,
            **{name: _estimate_percentile(q, counts, count, self.bounds,
                                          lo, hi)
               for name, q in (("p50", 0.50), ("p95", 0.95),
                               ("p99", 0.99))},
            "buckets": buckets,
        }


def escape_label_value(value: Any) -> str:
    """Prometheus text-exposition label-value escaping."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class MetricsRegistry:
    """Get-or-create registry of named instruments (one per name)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_TIME_BOUNDS
                  ) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name, bounds)
            return inst

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able {counters, gauges, histograms} snapshot."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: counters[k].value for k in sorted(counters)},
            "gauges": {k: gauges[k].value for k in sorted(gauges)},
            "histograms": {k: histograms[k].snapshot()
                           for k in sorted(histograms)},
        }

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4) of every instrument."""
        import re

        def family(name: str, kind: str) -> str:
            n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
            help_text = name.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {n} {help_text} (sparkdl_tpu_torch "
                         f"{kind})")
            lines.append(f"# TYPE {n} {kind}")
            return n

        lines: List[str] = []
        snap = self.snapshot()
        for name, value in snap["counters"].items():
            lines.append(f"{family(name, 'counter')} {value}")
        for name, value in snap["gauges"].items():
            if value is not None:
                lines.append(f"{family(name, 'gauge')} {value}")
        with self._lock:
            hists = dict(self._histograms)
        for name in sorted(hists):
            bounds, counts, count, total = hists[name]._raw()
            n = family(name, "histogram")
            cum = 0
            for i, bound in enumerate(bounds):
                cum += counts[i]
                le = escape_label_value(repr(bound))
                lines.append(f'{n}_bucket{{le="{le}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{n}_sum {total}")
            lines.append(f"{n}_count {count}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The scope
# ---------------------------------------------------------------------------

_run_counter = itertools.count(1)


class _RunContextFilter(logging.Filter):
    """Stamps run_id/trace_id onto log records."""

    def __init__(self, run_id: str, trace_id: str) -> None:
        super().__init__()
        self.run_id = run_id
        self.trace_id = trace_id

    def filter(self, record: logging.LogRecord) -> bool:
        record.run_id = self.run_id
        record.trace_id = self.trace_id
        return True


class Telemetry:
    """One run's telemetry scope: tracer + metrics + end-of-run report.

    ::

        with Telemetry("nightly-featurize", out_dir="/tmp/tel") as tel:
            pipeline.run()
        # exiting wrote sparkdl_run_report_<run_id>.json and
        # sparkdl_trace_<run_id>.json into out_dir

    ``out_dir`` defaults to ``$SPARKDL_TELEMETRY_DIR``; when neither is
    set no files are written and the scope is purely programmatic
    (``tel.tracer`` / ``tel.metrics`` / ``tel.report()``). While the
    scope is active, log records from the ``sparkdl_tpu_torch`` namespace
    carry ``.run_id`` / ``.trace_id``. To fold the active
    ``HealthMonitor``'s report into the run report, enter the monitor
    BEFORE (outside) the telemetry scope.
    """

    def __init__(self, name: str = "run", out_dir: Optional[str] = None,
                 max_spans: int = 65536,
                 run_id: Optional[str] = None) -> None:
        self.name = name
        self.out_dir = (out_dir if out_dir is not None
                        else os.environ.get(TELEMETRY_DIR_ENV))
        self.run_id = run_id or (
            f"{name}-{os.getpid():x}-{next(_run_counter):04x}")
        self.tracer = Tracer(trace_id=self.run_id, max_spans=max_spans)
        self.metrics = MetricsRegistry()
        self._prev: Optional["Telemetry"] = None
        self._root: Optional[_Span] = None
        self._prev_factory: Any = None
        self._filter = _RunContextFilter(self.run_id, self.run_id)
        self.report_path: Optional[str] = None
        self.trace_path: Optional[str] = None

    @property
    def root_context(self) -> Optional[SpanContext]:
        return self._root.context if self._root is not None else None

    def __enter__(self) -> "Telemetry":
        global _active
        with _activation_lock:
            self._prev = _active
            _active = self
            prev_factory = logging.getLogRecordFactory()
            self._prev_factory = prev_factory
            flt = self._filter

            def factory(*args: Any, **kwargs: Any) -> logging.LogRecord:
                record = prev_factory(*args, **kwargs)
                if record.name.startswith("sparkdl_tpu_torch"):
                    flt.filter(record)
                return record

            logging.setLogRecordFactory(factory)
        self._root = self.tracer.span(SPAN_RUN, parent=ROOT, run=self.name)
        self._root.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        global _active
        if self._root is not None:
            exc3 = exc if len(exc) == 3 else (None, None, None)
            self._root.__exit__(*exc3)
        with _activation_lock:
            _active = self._prev
            self._prev = None
            logging.setLogRecordFactory(self._prev_factory)
        if self.out_dir:
            try:
                self.write_report(self.out_dir)
            except OSError as e:
                logging.getLogger(__name__).error(
                    "could not write telemetry report to %r: %s",
                    self.out_dir, e)

    def report(self) -> Dict[str, Any]:
        return RunReport.build(self)

    def write_report(self, out_dir: str) -> str:
        """Write the run report + Chrome trace JSONs (each through a temp
        file and ``os.replace``); returns the report path."""
        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, f"sparkdl_trace_{self.run_id}.json")
        tmp = f"{trace_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.tracer.chrome_trace(), f)
        os.replace(tmp, trace_path)
        report = self.report()
        report["chrome_trace"] = trace_path
        report_path = os.path.join(
            out_dir, f"sparkdl_run_report_{self.run_id}.json")
        tmp = f"{report_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, default=str)
        os.replace(tmp, report_path)
        self.report_path, self.trace_path = report_path, trace_path
        return report_path


_active: Optional[Telemetry] = None
_activation_lock = threading.Lock()


def active() -> Optional[Telemetry]:
    return _active


def current_context() -> Optional[SpanContext]:
    """The ambient span context on THIS thread: innermost open span,
    else the context attached via :func:`attach`, else the active
    scope's root span. ``None`` without an active scope."""
    tel = _active
    if tel is None:
        return None
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1].context
    base = getattr(_tls, "base", None)
    if base is not None:
        return base
    return tel.root_context


def attach(ctx: Optional[SpanContext]) -> None:
    """Adopt ``ctx`` as this thread's base context: ambient spans opened
    here parent under it. For FRESH worker threads (the prefetcher's
    staging thread)."""
    _tls.base = ctx


def span(name: str, parent: Optional[SpanContext] = None,
         **attributes: Any) -> Any:
    """An open span on the active scope's tracer; the shared
    :data:`NULL_SPAN` singleton when no scope is active."""
    tel = _active
    if tel is None:
        return NULL_SPAN
    return tel.tracer.span(name, parent=parent, **attributes)


def count(name: str, n: int = 1) -> None:
    """Bump a counter on the active registry (no-op without a scope)."""
    tel = _active
    if tel is not None:
        tel.metrics.counter(name).inc(n)


def gauge_set(name: str, value: float) -> None:
    tel = _active
    if tel is not None:
        tel.metrics.gauge(name).set(value)


def observe(name: str, value: float,
            bounds: Sequence[float] = DEFAULT_TIME_BOUNDS) -> None:
    """Record one histogram observation on the active registry."""
    tel = _active
    if tel is not None:
        tel.metrics.histogram(name, bounds).observe(value)


def remote_span(name: str, start_abs_ns: int, end_abs_ns: int, *,
                pid: Optional[int] = None,
                **attributes: Any) -> Dict[str, Any]:
    """The wire record of a span measured in a process with no tracer (a
    decode-pool worker), its timestamps already on the adopting
    process's clock (the worker's ``perf_counter_ns`` plus the
    :func:`clock_handshake` offset); :meth:`Tracer.record_remote` turns
    it into a span. Raises for a name outside
    :data:`CANONICAL_SPAN_NAMES`, so a worker cannot ship one that the
    parent would refuse."""
    if name not in CANONICAL_SPAN_NAMES:
        raise ValueError(
            f"remote span name {name!r} is not in CANONICAL_SPAN_NAMES; "
            "span names crossing a process boundary must be canonical")
    rec: Dict[str, Any] = {
        "name": name,
        "start_ns": int(start_abs_ns),
        "end_ns": int(end_abs_ns),
        "pid": pid if pid is not None else os.getpid(),
    }
    if attributes:
        rec["attributes"] = attributes
    return rec


def clock_handshake(conn: Any, timeout_s: float = 5.0) -> int:
    """The worker's half of one NTP-style round trip over a dedicated
    pipe: send a ping, read the parent's ``perf_counter_ns`` and return
    the offset that maps this process's ``perf_counter_ns`` onto the
    parent's (``parent_ns ≈ local_ns + offset``, transit assumed
    symmetric). 0 (clocks taken as aligned: on Linux both read the same
    CLOCK_MONOTONIC) when the parent does not answer."""
    try:
        t0 = time.perf_counter_ns()
        conn.send(("clock", t0))
        if not conn.poll(timeout_s):
            return 0
        t_parent = conn.recv()
        t1 = time.perf_counter_ns()
        return int(t_parent) - (t0 + t1) // 2
    except (EOFError, OSError):
        return 0


class RunReport:
    """Assembles the single end-of-run JSON artifact: trace summary +
    metric snapshot + phase/overlap stats + health report."""

    @staticmethod
    def build(tel: Telemetry,
              health_monitor: Any = None) -> Dict[str, Any]:
        # lazy imports: profiling and health import this module
        from sparkdl_tpu_torch.core import health as _health
        from sparkdl_tpu_torch.core import profiling as _profiling

        mon = (health_monitor if health_monitor is not None
               else _health.active_monitor())
        return {
            "run_id": tel.run_id,
            "run": tel.name,
            "created_unix_s": round(time.time(), 3),
            "trace": tel.tracer.summary(),
            "metrics": tel.metrics.snapshot(),
            "phases": _profiling.phase_stats(),
            "overlap": _profiling.overlap_stats(),
            "health": mon.report() if mon is not None else None,
        }
