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
and are adopted with :meth:`Tracer.record_remote`. A process with a
tracer of its own (a cluster worker) ships its whole ring with
:meth:`Tracer.export_ring`, rebased onto the parent's clock, and the
parent merges it with :meth:`Tracer.adopt_remote_spans` (or, without
touching its own ring, :meth:`Tracer.merged_chrome_trace`); the merged
Chrome trace labels one process group per worker.

The live plane: every instrument a scope creates also feeds a fixed ring
of time-bucketed sub-counts (rotated lazily on the module clock
:data:`_monotonic`, O(1) per record), so
:meth:`MetricsRegistry.window_snapshot` answers "rate and p50/p95/p99
over the last N seconds" beside the cumulative views. A
:class:`SnapshotExporter` thread inside the scope appends a JSON-lines
snapshot (windowed, cumulative, the executor's and the serving plane's
state) and atomically replaces a Prometheus text file every
``export_interval_s``, evaluates the ``core.slo`` watchdog at each tick,
and flushes one last snapshot at scope exit; the run report gains a
``timeline`` built from the snapshots, and a snapshot a ``cluster`` key
while a cluster router with metrics federation is live. Cluster workers
pin the coordinator's run id (``Telemetry(run_id=...)``) and name their
files apart with ``Telemetry(process_scope=...)``.

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
# Opt-in periodic exporter cadence (seconds) for scopes that do not pass
# export_interval_s; file output needs TELEMETRY_DIR_ENV too.
EXPORT_INTERVAL_ENV = "SPARKDL_TELEMETRY_EXPORT_S"

# The window rings and the exporter read THIS clock (monotonic), so a
# test can drive rotation and cadence with a fake clock. The span path
# reads perf_counter_ns directly.
_monotonic = time.monotonic

# ---------------------------------------------------------------------------
# Canonical names: the reference's values, for the spans and metrics the
# port records.
# ---------------------------------------------------------------------------

SPAN_RUN = "sparkdl.run"                      # telemetry scope root
SPAN_FIT = "sparkdl.fit"                      # one Trainer.fit call
SPAN_EPOCH = "sparkdl.epoch"                  # one epoch of the fit loop
SPAN_CHECKPOINT_SAVE = "sparkdl.checkpoint_save"
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
SPAN_MODEL_LOAD = "sparkdl.model_load"        # serving cold start: the
                                              # loader run on a residency
                                              # miss (serving/residency.py)
SPAN_SERVING_SHADOW = "sparkdl.serving_shadow"  # shadow-lane replay of one
                                              # serving request
                                              # (serving/server.py)
SPAN_SERVING_PREDICT = "sparkdl.serving_predict"  # a cluster replica's
                                              # run of one routed predict
                                              # (serving/cluster.py)
SPAN_SERVING_WARMUP = "sparkdl.serving.warmup_s"  # bucket-ladder warm-up
                                              # of one deployment
                                              # (serving/registry.py)
SPAN_CLUSTER_DISPATCH = "sparkdl.cluster_dispatch"  # one partition's
                                              # round trip to a cluster
                                              # worker (cluster/router.py)
SPAN_CLUSTER_TASK = "sparkdl.cluster_task"    # a worker's run of one
                                              # dispatched partition
                                              # (cluster/worker.py)

CANONICAL_SPAN_NAMES = frozenset({
    SPAN_RUN, SPAN_FIT, SPAN_EPOCH, SPAN_CHECKPOINT_SAVE, SPAN_MATERIALIZE,
    SPAN_TASK, SPAN_TASK_ATTEMPT, SPAN_COMPILE,
    SPAN_COALESCED_LAUNCH, SPAN_DECODE_POOL, SPAN_DECODE_CHUNK,
    SPAN_MODEL_LOAD, SPAN_SERVING_SHADOW, SPAN_SERVING_PREDICT,
    SPAN_SERVING_WARMUP, SPAN_CLUSTER_DISPATCH, SPAN_CLUSTER_TASK,
    # phase names (core/profiling.py constants + literal call sites)
    "sparkdl.decode", "sparkdl.stage", "sparkdl.stage_batch",
    "sparkdl.host_stage", "sparkdl.host_resize", "sparkdl.host_wait",
    "sparkdl.device_apply", "sparkdl.train_step", "sparkdl.device_sync",
})

# Metric catalog. Histograms in seconds use DEFAULT_TIME_BOUNDS; row-count
# histograms use POW2_BOUNDS. Health-event mirrors are dynamic:
# "sparkdl.health.<event>" per core/health.py event name, bumped in
# health.record so telemetry counters equal HealthMonitor counts exactly.
M_TASK_DURATION_S = "sparkdl.task.duration_s"          # histogram
M_STEP_TIME_S = "sparkdl.train.step_time_s"            # histogram (host)
M_STEPS_PER_SEC = "sparkdl.train.steps_per_sec"        # histogram
M_EXAMPLES_PER_SEC = "sparkdl.train.examples_per_sec"  # gauge
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
# The online serving plane (serving/): each request's end-to-end
# latency, the in-flight predict calls, the shadow leg's max
# |active - shadow| and the residency evictions. Per-model latency
# histograms are declared at deploy time as
# "sparkdl.serving.request_s.<model>" (serving_request_metric).
M_SERVING_REQUEST_S = "sparkdl.serving.request_s"      # histogram (e2e)
M_SERVING_QUEUE_DEPTH = "sparkdl.serving.queue_depth"  # gauge (in flight)
M_SERVING_SHADOW_DIVERGENCE = "sparkdl.serving.shadow_divergence"
                                                       # histogram
M_SERVING_EVICTIONS = "sparkdl.serving.evictions"      # counter
# The cluster serving plane's two series, named now so rules over them
# validate; nothing of the port records them until that plane is ported.
M_SERVING_FAILOVER = "sparkdl.serving.failover"        # counter
M_SERVING_REPLICAS = "sparkdl.serving.replicas"        # gauge
# The cluster inference plane (cluster/): the router's view of rows in
# flight across workers, each partition's round trip and each
# re-dispatch after a worker died (the losses and re-dispatches also
# arrive as sparkdl.health.* mirrors); the live worker count and how
# long a drain takes from its notice to the worker's clean exit.
M_CLUSTER_OUTSTANDING_ROWS = "sparkdl.cluster.outstanding_rows"  # gauge
M_CLUSTER_DISPATCH_S = "sparkdl.cluster.dispatch_s"    # histogram
M_CLUSTER_REDISPATCH = "sparkdl.cluster.redispatch"    # counter
M_CLUSTER_WORKERS = "sparkdl.cluster.workers"          # gauge (live,
                                                       # not draining)
M_CLUSTER_DRAIN_S = "sparkdl.cluster.drain_s"          # histogram
HEALTH_METRIC_PREFIX = "sparkdl.health."

CANONICAL_METRIC_KINDS: Dict[str, str] = {
    M_TASK_DURATION_S: "histogram",
    M_STEP_TIME_S: "histogram",
    M_STEPS_PER_SEC: "histogram",
    M_EXAMPLES_PER_SEC: "gauge",
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
    M_SERVING_REQUEST_S: "histogram",
    M_SERVING_QUEUE_DEPTH: "gauge",
    M_SERVING_SHADOW_DIVERGENCE: "histogram",
    M_SERVING_EVICTIONS: "counter",
    M_SERVING_FAILOVER: "counter",
    M_SERVING_REPLICAS: "gauge",
    M_CLUSTER_OUTSTANDING_ROWS: "gauge",
    M_CLUSTER_DISPATCH_S: "histogram",
    M_CLUSTER_REDISPATCH: "counter",
    M_CLUSTER_WORKERS: "gauge",
    M_CLUSTER_DRAIN_S: "histogram",
}

CANONICAL_METRIC_NAMES = frozenset(CANONICAL_METRIC_KINDS)

_declare_lock = threading.Lock()


def declare_metric(name: str, kind: str) -> str:
    """Declare a DYNAMIC metric name (the per-model serving latency and
    the per-tenant queue-wait histograms) into the catalog, so an
    ``slo.SLORule`` over it validates. Idempotent; re-declaring with a
    DIFFERENT kind raises (two writers disagreeing on the instrument
    would corrupt every rule watching it). Returns ``name``."""
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


def serving_request_metric(model: str) -> str:
    """The per-model serving latency histogram name: metrics carry no
    labels, so per-model p99 objectives get per-model NAMES, declared at
    deploy time and observed by the ModelServer beside the aggregate
    ``M_SERVING_REQUEST_S``."""
    return M_SERVING_REQUEST_S + "." + model


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

    def export_ring(self, *, clock_offset_ns: int = 0,
                    process: Optional[str] = None,
                    parent_remap: Optional[Dict[int, int]] = None,
                    limit: int = 4096) -> Dict[str, Any]:
        """The shippable view of this ring: every span rebased onto the
        PARENT's clock (``abs_ns = rel + t0 + offset``, the offset from
        :func:`clock_handshake`) and stamped with this process's pid and
        ``process`` label. ``parent_remap`` rewrites parent ids: a
        worker's still-open ``sparkdl.run`` root never ships, so spans
        under it re-parent onto the coordinator's root. Keeps the newest
        ``limit`` spans; what it leaves out adds to the shipped
        ``dropped``."""
        spans = self.spans()
        shipped_dropped = self.dropped
        if len(spans) > limit:
            shipped_dropped += len(spans) - limit
            spans = spans[-limit:]
        pid = os.getpid()
        remap = parent_remap or {}
        out = []
        for s in spans:
            rec = dict(s)
            rec["start_ns"] = s["start_ns"] + self._t0_ns + clock_offset_ns
            rec["end_ns"] = s["end_ns"] + self._t0_ns + clock_offset_ns
            rec["pid"] = pid
            if process is not None:
                rec["process"] = process
            parent = rec.get("parent_id")
            if parent in remap:
                rec["parent_id"] = remap[parent]
            out.append(rec)
        return {"spans": out, "dropped": shipped_dropped,
                "clock_offset_ns": clock_offset_ns}

    def merged_chrome_trace(self, rings: Sequence[Dict[str, Any]]
                            ) -> Dict[str, Any]:
        """A Chrome-trace document of this ring's current spans merged
        with :meth:`export_ring` payloads, leaving this ring untouched (a
        mid-run postmortem pulls rings that the workers ship again at
        close; adopting them here would count them twice). A scratch
        tracer on this tracer's epoch does the merge."""
        scratch = Tracer(self.trace_id, max_spans=self.max_spans)
        scratch._t0_ns = self._t0_ns
        with self._lock:
            scratch._spans.extend(dict(s) for s in self._spans)
        for ring in rings:
            scratch.adopt_remote_spans(ring.get("spans") or ())
        return scratch.chrome_trace()

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
        the process that measured them; once another process's spans are
        in, each pid gets a ``process_name`` label (``coordinator`` for
        this one, a worker's its ``process``)."""
        events: List[Dict[str, Any]] = []
        own = os.getpid()
        seen_threads: Dict[Tuple[int, int], str] = {}
        seen_procs: Dict[int, Optional[str]] = {}
        for s in self.spans():
            pid = s.get("pid", own)
            seen_threads.setdefault((pid, s["thread_id"]), s["thread_name"])
            if s.get("process") is not None or pid not in seen_procs:
                seen_procs[pid] = s.get("process") or seen_procs.get(pid)
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
        # process labels only once remote spans merged in: a trace of one
        # process keeps its shape
        if len(seen_procs) > 1 or any(seen_procs.values()):
            for pid, label in seen_procs.items():
                name = label or ("coordinator" if pid == own
                                 else f"pid-{pid}")
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": name}})
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


def _window_floor(span_s: float, slots: int, window_s: float) -> int:
    """Oldest slot epoch inside a trailing ``window_s`` window (clamped
    to the ring capacity). The current partial slot is always included,
    so the effective window is ``window_s`` ± one slot span."""
    k = min(slots, max(1, math.ceil(window_s / span_s)))
    return int(_monotonic() / span_s) - k + 1


class Counter:
    """Monotonic counter. With ``window=(span_s, slots)`` it also keeps a
    fixed ring of time-bucketed sub-counts (lazy monotonic-clock
    rotation, O(1) per inc) so :meth:`window_count` can answer "how many
    in the last N seconds" without a timer thread."""

    __slots__ = ("name", "_lock", "_value", "_w_span", "_w_epochs",
                 "_w_counts")

    def __init__(self, name: str,
                 window: Optional[Tuple[float, int]] = None) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0
        self._w_span: Optional[float] = None
        if window is not None:
            span_s, slots = window
            self._w_span = float(span_s)
            self._w_epochs = [-1] * slots
            self._w_counts = [0] * slots

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
            if self._w_span is not None:
                epoch = int(_monotonic() / self._w_span)
                i = epoch % len(self._w_counts)
                if self._w_epochs[i] != epoch:  # lazy rotation
                    self._w_epochs[i] = epoch
                    self._w_counts[i] = 0
                self._w_counts[i] += n

    def window_count(self, window_s: float) -> int:
        """Occurrences within the trailing ``window_s`` (0 without a
        ring; resolution = one ring slot)."""
        if self._w_span is None:
            return 0
        with self._lock:
            floor_epoch = _window_floor(self._w_span, len(self._w_counts),
                                        window_s)
            return sum(c for e, c in zip(self._w_epochs, self._w_counts)
                       if e >= floor_epoch)

    def window_frame(self) -> Dict[int, int]:
        """Per-slot ``{epoch: count}`` export of the live ring (one
        consistent locked copy): the reference's metrics-federation wire
        format. Epochs are THIS process's monotonic slot indices. Empty
        without a ring."""
        if self._w_span is None:
            return {}
        with self._lock:
            floor_epoch = _window_floor(
                self._w_span, len(self._w_counts),
                self._w_span * len(self._w_counts))
            return {e: c for e, c in zip(self._w_epochs, self._w_counts)
                    if e >= floor_epoch and c}

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value. With ``window=`` it also
    remembers (last, min, max) per ring slot so the windowed view can
    report the envelope of the last N seconds, not just the final
    write."""

    __slots__ = ("name", "_lock", "_value", "_w_span", "_w_epochs",
                 "_w_vals")

    def __init__(self, name: str,
                 window: Optional[Tuple[float, int]] = None) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None
        self._w_span: Optional[float] = None
        if window is not None:
            span_s, slots = window
            self._w_span = float(span_s)
            self._w_epochs = [-1] * slots
            self._w_vals: List[Optional[Tuple[float, float, float]]] = \
                [None] * slots

    def set(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._value = value
            if self._w_span is not None:
                epoch = int(_monotonic() / self._w_span)
                i = epoch % len(self._w_vals)
                if self._w_epochs[i] != epoch:
                    self._w_epochs[i] = epoch
                    self._w_vals[i] = (value, value, value)
                else:
                    last, lo, hi = self._w_vals[i]  # type: ignore[misc]
                    self._w_vals[i] = (value, min(lo, value),
                                       max(hi, value))

    def window_values(self, window_s: float) -> Optional[Dict[str, float]]:
        """``{'last', 'min', 'max'}`` over the trailing window; ``None``
        when the window saw no :meth:`set` (or there is no ring)."""
        if self._w_span is None:
            return None
        with self._lock:
            floor_epoch = _window_floor(self._w_span, len(self._w_vals),
                                        window_s)
            seen = sorted((e, v) for e, v in zip(self._w_epochs,
                                                 self._w_vals)
                          if e >= floor_epoch and v is not None)
        if not seen:
            return None
        return {"last": seen[-1][1][0],
                "min": min(v[1] for _, v in seen),
                "max": max(v[2] for _, v in seen)}

    def window_frame(self) -> Dict[int, List[float]]:
        """Per-slot ``{epoch: [last, min, max]}`` envelope export of the
        live ring — the federation wire format for gauges (see
        :meth:`Counter.window_frame`). Empty without a ring."""
        if self._w_span is None:
            return {}
        with self._lock:
            floor_epoch = _window_floor(
                self._w_span, len(self._w_vals),
                self._w_span * len(self._w_vals))
            return {e: list(v) for e, v in zip(self._w_epochs,
                                               self._w_vals)
                    if e >= floor_epoch and v is not None}

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Fixed log-scale-bucket histogram with percentile estimates.

    Buckets are upper bounds (Prometheus ``le`` semantics) growing by a
    constant factor (default 2×), so the relative error of a percentile
    estimate is bounded by the factor. p50/p95/p99 are estimated at the
    geometric midpoint of the covering bucket, clamped to the observed
    [min, max].
    """

    __slots__ = ("name", "_lock", "bounds", "_counts", "count", "sum",
                 "min", "max", "_w_span", "_w_epochs", "_w_slots",
                 "_ex_k", "_w_ex")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_TIME_BOUNDS,
                 window: Optional[Tuple[float, int]] = None,
                 exemplar_k: int = 0) -> None:
        self.name = name
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._w_span: Optional[float] = None
        # opt-in tail-exemplar reservoir: the top-k observations per
        # window slot, each carrying the span context that produced it —
        # a breached p99 points at concrete traces, not just a number
        self._ex_k = int(exemplar_k) if window is not None else 0
        if window is not None:
            span_s, slots = window
            self._w_span = float(span_s)
            self._w_epochs = [-1] * slots
            # one sub-histogram per ring slot: [counts, count, sum, min,
            # max]; reset lazily when its slot's epoch rotates past
            self._w_slots: List[List[Any]] = [
                [[0] * (len(self.bounds) + 1), 0, 0.0, None, None]
                for _ in range(slots)]
            if self._ex_k:
                # per-slot exemplar list, ascending by value (min first
                # for O(1) eviction checks at tiny fixed k)
                self._w_ex: List[List[Tuple[float, str, int]]] = [
                    [] for _ in range(slots)]

    def observe(self, value: float,
                exemplar: Optional[SpanContext] = None) -> None:
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
            if self._w_span is not None:
                epoch = int(_monotonic() / self._w_span)
                i = epoch % len(self._w_slots)
                slot = self._w_slots[i]
                if self._w_epochs[i] != epoch:  # lazy rotation
                    self._w_epochs[i] = epoch
                    slot[0] = [0] * (len(self.bounds) + 1)
                    slot[1], slot[2] = 0, 0.0
                    slot[3] = slot[4] = None
                    if self._ex_k:
                        self._w_ex[i] = []
                slot[0][idx] += 1
                slot[1] += 1
                slot[2] += value
                if slot[3] is None or value < slot[3]:
                    slot[3] = value
                if slot[4] is None or value > slot[4]:
                    slot[4] = value
                if self._ex_k and exemplar is not None:
                    ex = self._w_ex[i]
                    if len(ex) < self._ex_k:
                        bisect.insort(
                            ex, (value, exemplar.trace_id,
                                 exemplar.span_id))
                    elif value > ex[0][0]:  # beats the smallest kept
                        ex.pop(0)
                        bisect.insort(
                            ex, (value, exemplar.trace_id,
                                 exemplar.span_id))

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]) from the bucket counts
        (``None`` on an empty histogram)."""
        with self._lock:
            return _estimate_percentile(q, self._counts, self.count,
                                        self.bounds, self.min, self.max)

    def _raw(self) -> Tuple[Tuple[float, ...], List[int], int, float]:
        """(bounds, counts, count, sum) as one consistent locked copy —
        the Prometheus exposition source."""
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
        # percentiles from the SAME locked copy as the buckets (a
        # concurrent observe between the copy and the estimate cannot
        # skew them apart), None — not a midpoint guess — when empty
        return {
            "count": count, "sum": round(total, 9), "min": lo, "max": hi,
            "p50": _estimate_percentile(0.50, counts, count, self.bounds,
                                        lo, hi),
            "p95": _estimate_percentile(0.95, counts, count, self.bounds,
                                        lo, hi),
            "p99": _estimate_percentile(0.99, counts, count, self.bounds,
                                        lo, hi),
            "buckets": buckets,
        }

    def window_snapshot(self, window_s: float) -> Dict[str, Any]:
        """Merged ``{count, sum, rate_per_s, min, max, p50, p95, p99}``
        over the trailing ``window_s`` (resolution = one ring slot).
        Percentiles and min/max are ``None`` on an empty window; all
        zeros/None without a ring. With an armed exemplar reservoir the
        snapshot additionally carries ``exemplars``: the top-k in-window
        observations (descending), each
        ``{value, trace_id, span_id}`` — the key is absent entirely when
        exemplars are off, keeping the unarmed shape unchanged."""
        counts = [0] * (len(self.bounds) + 1)
        count, total = 0, 0.0
        vmin: Optional[float] = None
        vmax: Optional[float] = None
        exemplars: List[Tuple[float, str, int]] = []
        if self._w_span is not None:
            with self._lock:
                floor_epoch = _window_floor(self._w_span,
                                            len(self._w_slots), window_s)
                for i, (e, slot) in enumerate(zip(self._w_epochs,
                                                  self._w_slots)):
                    if e < floor_epoch or not slot[1]:
                        continue
                    for j, c in enumerate(slot[0]):
                        counts[j] += c
                    count += slot[1]
                    total += slot[2]
                    vmin = slot[3] if vmin is None else min(vmin, slot[3])
                    vmax = slot[4] if vmax is None else max(vmax, slot[4])
                    if self._ex_k:
                        exemplars.extend(self._w_ex[i])
        out = {
            "count": count, "sum": round(total, 9),
            "rate_per_s": round(count / window_s, 9) if window_s else 0.0,
            "min": vmin, "max": vmax,
            "p50": _estimate_percentile(0.50, counts, count, self.bounds,
                                        vmin, vmax),
            "p95": _estimate_percentile(0.95, counts, count, self.bounds,
                                        vmin, vmax),
            "p99": _estimate_percentile(0.99, counts, count, self.bounds,
                                        vmin, vmax),
        }
        if self._ex_k:
            exemplars.sort(reverse=True)
            out["exemplars"] = [
                {"value": v, "trace_id": t, "span_id": s}
                for v, t, s in exemplars[:self._ex_k]]
        return out

    def window_frame(self) -> Dict[int, List[Any]]:
        """Per-slot sub-histogram export of the live ring, keyed by slot
        epoch: ``{epoch: [bucket_counts, count, sum, min, max]}`` (with
        an armed exemplar reservoir each entry appends its slot's
        ``[(value, trace_id, span_id), ...]`` list). Mergeable by
        construction: bucket counts sum across processes per epoch, so a
        merged percentile comes from ONE bucket array. Empty without a
        ring."""
        if self._w_span is None:
            return {}
        out: Dict[int, List[Any]] = {}
        with self._lock:
            floor_epoch = _window_floor(
                self._w_span, len(self._w_slots),
                self._w_span * len(self._w_slots))
            for i, (e, slot) in enumerate(zip(self._w_epochs,
                                              self._w_slots)):
                if e < floor_epoch or not slot[1]:
                    continue
                entry: List[Any] = [list(slot[0]), slot[1], slot[2],
                                    slot[3], slot[4]]
                if self._ex_k:
                    entry.append([list(ex) for ex in self._w_ex[i]])
                out[e] = entry
        return out


def escape_label_value(value: Any) -> str:
    """Prometheus text-exposition label-value escaping: backslash,
    double-quote and newline (in that order, per the 0.0.4 format)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal
    in HELP text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class MetricsRegistry:
    """Get-or-create registry of named instruments (one per name).

    ``window_s``/``window_buckets`` arm the sliding-window rings on every
    instrument the registry creates: ``window_s`` is the largest
    queryable trailing window, bucketed into ``window_buckets`` ring
    slots (the window resolution). ``window_s=None`` (the bare-registry
    default) creates ring-free instruments — the pre-windowing record
    path, not even a clock read per record.

    ``exemplar_k`` (opt-in, default 0 = off) arms a per-slot tail
    exemplar reservoir on every histogram created here: callers passing
    a span context to :meth:`Histogram.observe` get their top-k
    observations per window surfaced with ``{value, trace_id, span_id}``
    in windowed snapshots."""

    def __init__(self, window_s: Optional[float] = None,
                 window_buckets: int = 12, exemplar_k: int = 0) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._window: Optional[Tuple[float, int]] = None
        if exemplar_k < 0:
            raise ValueError(f"exemplar_k must be >= 0, got {exemplar_k!r}")
        self.exemplar_k = int(exemplar_k)
        if window_s is not None:
            if window_s <= 0 or window_buckets <= 0:
                raise ValueError(
                    "window_s and window_buckets must be > 0, got "
                    f"{window_s!r}/{window_buckets!r}")
            self._window = (float(window_s) / int(window_buckets),
                            int(window_buckets))
        self.window_s = window_s

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(
                    name, window=self._window)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name,
                                                  window=self._window)
            return inst

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_TIME_BOUNDS
                  ) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(
                    name, bounds, window=self._window,
                    exemplar_k=self.exemplar_k)
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

    def window_snapshot(self, window_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Sliding-window view over every instrument: counter counts and
        rates, gauge last/min/max envelopes, histogram percentiles —
        all over the trailing ``window_s`` seconds (default and cap: the
        ring capacity). Resolution is one ring slot, and the current
        partial slot is included, so the effective window is
        ``window_s`` ± one slot. Empty sections when the registry was
        built without windows."""
        if self._window is None:
            return {"window_s": None, "counters": {}, "gauges": {},
                    "histograms": {}}
        span, slots = self._window
        if window_s is None:
            window_s = span * slots
        window_s = min(float(window_s), span * slots)
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s!r}")
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        out_counters = {}
        for k in sorted(counters):
            c = counters[k].window_count(window_s)
            out_counters[k] = {"count": c,
                               "rate_per_s": round(c / window_s, 9)}
        out_gauges = {}
        for k in sorted(gauges):
            v = gauges[k].window_values(window_s)
            if v is not None:
                out_gauges[k] = v
        return {
            "window_s": window_s,
            "counters": out_counters,
            "gauges": out_gauges,
            "histograms": {k: histograms[k].window_snapshot(window_s)
                           for k in sorted(histograms)},
        }

    def export_frame(self) -> Optional[Dict[str, Any]]:
        """The bounded metrics-federation delta frame: every windowed
        instrument's live ring slots keyed by slot epoch, restricted to
        the canonical catalog plus the ``sparkdl.health.*`` mirrors.
        ``None`` without windows: there is nothing windowed to
        federate. Frame size is bounded by construction — ring slots ×
        bucket counts per instrument, independent of traffic volume —
        and each frame is the full state of the ring (a receiver merges
        by replacing), so a dropped frame heals on the next cadence
        instead of leaving a permanent gap."""
        if self._window is None:
            return None
        span, slots = self._window
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)

        def declared(name: str) -> bool:
            return (name in CANONICAL_METRIC_NAMES
                    or name.startswith(HEALTH_METRIC_PREFIX))

        out_counters: Dict[str, Any] = {}
        for name in sorted(counters):
            if declared(name):
                frame = counters[name].window_frame()
                if frame:
                    out_counters[name] = frame
        out_gauges: Dict[str, Any] = {}
        for name in sorted(gauges):
            if declared(name):
                frame = gauges[name].window_frame()
                if frame:
                    out_gauges[name] = frame
        out_hists: Dict[str, Any] = {}
        for name in sorted(histograms):
            if declared(name):
                frame = histograms[name].window_frame()
                if frame:
                    out_hists[name] = {
                        "bounds": list(histograms[name].bounds),
                        "slots": frame,
                    }
        return {
            "span_s": span,
            "slots": slots,
            "now_epoch": int(_monotonic() / span),
            "counters": out_counters,
            "gauges": out_gauges,
            "histograms": out_hists,
        }

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4) dump of every instrument:
        one ``# HELP`` + ``# TYPE`` pair per metric family, escaped
        label values, cumulative histogram buckets with a closing
        ``+Inf``."""
        import re as _re

        def sane(name: str) -> str:
            return _re.sub(r"[^a-zA-Z0-9_:]", "_", name)

        lines: List[str] = []

        def family(name: str, kind: str) -> str:
            n = sane(name)
            lines.append(
                f"# HELP {n} {_escape_help(name)} (sparkdl_tpu_torch {kind})")
            lines.append(f"# TYPE {n} {kind}")
            return n

        snap = self.snapshot()
        for name, value in snap["counters"].items():
            n = family(name, "counter")
            lines.append(f"{n} {value}")
        for name, value in snap["gauges"].items():
            if value is None:
                continue
            n = family(name, "gauge")
            lines.append(f"{n} {value}")
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
# Periodic snapshot exporter (the live half of the run report)
# ---------------------------------------------------------------------------


class SnapshotExporter:
    """Periodic live-snapshot exporter for one telemetry scope.

    Every ``interval_s`` (daemon thread; drop-safe final flush at
    :meth:`close`) a tick:

    - appends one JSON line — sequence number, uptime, windowed +
      cumulative metric snapshots, executor queue/breaker state — to
      ``sparkdl_snapshots_<run_id>.jsonl`` under ``out_dir``;
    - atomically replaces ``sparkdl_metrics_<run_id>.prom`` (temp file +
      ``os.replace``) so a Prometheus textfile collector never reads a
      torn exposition;
    - evaluates the scope's SLO watchdog (``core/slo.py``) so breaches
      surface while the process is alive, not in the post-mortem.

    Without an ``out_dir`` no files are written but ticks still run
    (watchdog + the bounded in-memory timeline that feeds the run
    report). A tick that crashes records one ``telemetry_export_error``
    health event and keeps going — the exporter never takes the run
    down and never dies silently.
    """

    def __init__(self, tel: "Telemetry", interval_s: float,
                 out_dir: Optional[str] = None, watchdog: Any = None,
                 timeline_max: int = 240) -> None:
        if interval_s <= 0:
            raise ValueError(
                f"export_interval_s must be > 0, got {interval_s!r}")
        self.tel = tel
        self.interval_s = float(interval_s)
        self.out_dir = out_dir
        self.watchdog = watchdog
        self.seq = 0
        self.errors = 0
        self.snapshot_path: Optional[str] = None
        self.prom_path: Optional[str] = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            # cluster workers pin the coordinator's run id, so a shared
            # out_dir needs the scope's process suffix (the coordinator,
            # process_scope None, keeps the bare names)
            suffix = _scope_suffix(tel)
            self.snapshot_path = os.path.join(
                out_dir, f"sparkdl_snapshots_{tel.run_id}{suffix}.jsonl")
            self.prom_path = os.path.join(
                out_dir, f"sparkdl_metrics_{tel.run_id}{suffix}.prom")
        self._t0 = _monotonic()
        self._next_due = self._t0 + self.interval_s
        self._tick_lock = threading.Lock()  # thread tick vs close flush
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._timeline: "deque[Dict[str, Any]]" = deque(maxlen=timeline_max)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"sparkdl-telemetry-export-{self.tel.run_id}")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            wait_s = max(0.005, min(self._next_due - _monotonic(),
                                    self.interval_s))
            if self._stop.wait(timeout=wait_s):
                return
            self.tick_if_due()

    def close(self) -> None:
        """Stop the thread, then flush one final snapshot — the tail of
        the run (where failures live) is never lost to cadence."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.tick(final=True)

    # -- ticking -------------------------------------------------------------

    def tick_if_due(self) -> bool:
        """Export iff the cadence clock says a snapshot is due."""
        now = _monotonic()
        if now < self._next_due:
            return False
        self._next_due = now + self.interval_s
        self.tick()
        return True

    def tick(self, final: bool = False) -> None:
        """One export. Never raises: a crashed tick records ONE
        ``telemetry_export_error`` health event and returns, so the
        exporter thread survives and the next tick gets a fresh try."""
        from sparkdl_tpu_torch.core import health  # lazy: health imports us

        try:
            with self._tick_lock:
                self._export(final=final)
        except Exception as e:  # noqa: BLE001 - recorded, never re-raised
            self.errors += 1
            health.record(health.TELEMETRY_EXPORT_ERROR,
                          error=type(e).__name__, seq=self.seq)
            logging.getLogger(__name__).exception(
                "telemetry snapshot export failed (seq %d): %s",
                self.seq, e)

    def _export(self, final: bool) -> None:
        now = _monotonic()
        tel = self.tel
        self.seq += 1
        slo_state = (self.watchdog.evaluate(tel.metrics, now=now)
                     if self.watchdog is not None else None)
        snap: Dict[str, Any] = {
            "seq": self.seq,
            "run_id": tel.run_id,
            "uptime_s": round(now - self._t0, 6),
            "created_unix_s": round(time.time(), 3),
            "windowed": tel.metrics.window_snapshot(),
            "cumulative": tel.metrics.snapshot(),
            "executor": self._executor_status(),
        }
        serving = self._serving_status()
        if serving is not None:
            snap["serving"] = serving
        cluster = self._cluster_status()
        if cluster is not None:
            snap["cluster"] = cluster
        if slo_state is not None:
            snap["slo"] = slo_state
        if final:
            snap["final"] = True
        self._timeline.append(self._compact(snap))
        # the writes run under _tick_lock: serializing them against the
        # close() flush is that lock's job
        if self.snapshot_path is not None:
            with open(self.snapshot_path, "a") as f:
                f.write(json.dumps(snap, default=str) + "\n")
                f.flush()
        if self.prom_path is not None:
            tmp = self.prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(tel.metrics.prometheus_text())
                f.write(self._cluster_prometheus_text())
            os.replace(tmp, self.prom_path)

    @staticmethod
    def _executor_status() -> Optional[Dict[str, Any]]:
        """Queue/breaker state of the device execution service, read only
        when the process already imported it (``sys.modules``, not an
        import: a job that never ran the executor does not pay for it)."""
        import sys

        mod = sys.modules.get("sparkdl_tpu_torch.core.executor")
        if mod is None:
            return None
        return mod.service().status()

    @staticmethod
    def _serving_status() -> Optional[Dict[str, Any]]:
        """The live ModelServers' in-flight depth and models, and beside
        them (``cluster``) the cluster serving router's replica map, each
        read the same way as :meth:`_executor_status`: a process that
        never imported the serving plane, or built no server, gets no
        ``serving`` key, and one that never imported the cluster serving
        plane no ``cluster`` in it."""
        import sys

        out: Dict[str, Any] = {}
        mod = sys.modules.get("sparkdl_tpu_torch.serving.server")
        servers = mod.exporter_status() if mod is not None else None
        if servers is not None:
            out.update(servers)
        mod = sys.modules.get("sparkdl_tpu_torch.serving.cluster")
        replicas = mod.exporter_status() if mod is not None else None
        if replicas is not None:
            out["cluster"] = replicas
        return out or None

    @staticmethod
    def _cluster_status() -> Optional[Dict[str, Any]]:
        """The federated view of the live partition router (the windowed
        cluster-wide fold and ``workers_reporting``), read the same way
        as :meth:`_executor_status`: a run that never imported the
        cluster plane, or whose router has no federation, gets no
        ``cluster`` key."""
        import sys

        mod = sys.modules.get("sparkdl_tpu_torch.cluster.router")
        if mod is None:
            return None
        return mod.exporter_status()

    @staticmethod
    def _cluster_prometheus_text() -> str:
        """The live router's federated Prometheus series, or ``""``."""
        import sys

        mod = sys.modules.get("sparkdl_tpu_torch.cluster.router")
        if mod is None:
            return ""
        return mod.exporter_prometheus_text()

    # -- the timeline that feeds RunReport -----------------------------------

    @staticmethod
    def _compact(snap: Dict[str, Any]) -> Dict[str, Any]:
        """One bounded timeline entry per snapshot: windowed activity
        (non-empty instruments only) + the SLO verdicts."""
        windowed = snap["windowed"]
        entry: Dict[str, Any] = {
            "seq": snap["seq"],
            "uptime_s": snap["uptime_s"],
            "windowed_histograms": {
                k: {"count": v["count"], "p50": v["p50"], "p99": v["p99"]}
                for k, v in windowed["histograms"].items() if v["count"]},
            "windowed_counters": {
                k: v for k, v in windowed["counters"].items()
                if v["count"]},
        }
        if snap.get("slo") is not None:
            entry["slo_breached"] = sorted(
                name for name, st in snap["slo"].items() if st["breached"])
            exemplars = {
                name: st["exemplars"]
                for name, st in snap["slo"].items()
                if st["breached"] and st.get("exemplars")}
            if exemplars:
                entry["slo_exemplars"] = exemplars
        if snap.get("final"):
            entry["final"] = True
        return entry

    def timeline_summary(self) -> Dict[str, Any]:
        """The run report's ``timeline`` block: exporter stats + the
        (bounded, tail-keeping) compact snapshot entries."""
        return {
            "export_interval_s": self.interval_s,
            "snapshots": self.seq,
            "errors": self.errors,
            "snapshot_path": self.snapshot_path,
            "prometheus_path": self.prom_path,
            "entries": list(self._timeline),
        }


# ---------------------------------------------------------------------------
# The scope
# ---------------------------------------------------------------------------

_run_counter = itertools.count(1)


def _scope_suffix(tel: Any) -> str:
    scope = getattr(tel, "process_scope", None)
    return f".{scope}" if scope else ""


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
    (``tel.tracer`` / ``tel.metrics`` / ``tel.report()``).
    ``window_s``/``window_buckets`` size every instrument's ring (None: no
    rings); ``export_interval_s`` (or ``$SPARKDL_TELEMETRY_EXPORT_S``)
    starts the :class:`SnapshotExporter`, which evaluates ``slo_rules``
    (default: ``slo.DEFAULT_RULES``, re-windowed to a smaller ring) at
    each tick; ``exemplar_k`` keeps the top-k observations per ring slot
    with their span contexts. While the
    scope is active, log records from the ``sparkdl_tpu_torch`` namespace
    carry ``.run_id`` / ``.trace_id``. To fold the active
    ``HealthMonitor``'s report into the run report, enter the monitor
    BEFORE (outside) the telemetry scope. ``run_id`` pins the scope's
    identity (a restarted durable job, ``durability.pinned_run_id``; a
    cluster worker, the coordinator's); ``process_scope`` then tells the
    files of processes sharing one run id and ``out_dir`` apart.
    """

    def __init__(self, name: str = "run", out_dir: Optional[str] = None,
                 max_spans: int = 65536,
                 window_s: Optional[float] = 60.0,
                 window_buckets: int = 12,
                 export_interval_s: Optional[float] = None,
                 slo_rules: Optional[Sequence[Any]] = None,
                 run_id: Optional[str] = None,
                 exemplar_k: int = 0,
                 process_scope: Optional[str] = None) -> None:
        self.name = name
        self.out_dir = (out_dir if out_dir is not None
                        else os.environ.get(TELEMETRY_DIR_ENV))
        self.run_id = run_id or (
            f"{name}-{os.getpid():x}-{next(_run_counter):04x}")
        self.process_scope = process_scope
        self.tracer = Tracer(trace_id=self.run_id, max_spans=max_spans)
        self.metrics = MetricsRegistry(window_s=window_s,
                                       window_buckets=window_buckets,
                                       exemplar_k=exemplar_k)
        if export_interval_s is None:
            env = os.environ.get(EXPORT_INTERVAL_ENV)
            export_interval_s = float(env) if env else None
        if export_interval_s is not None and export_interval_s <= 0:
            raise ValueError("export_interval_s must be > 0, got "
                             f"{export_interval_s!r}")
        self.export_interval_s = export_interval_s
        if slo_rules is not None and window_s is not None:
            # a rule window past the ring's capacity would judge over
            # less history than it declares: refuse it here, where both
            # are in hand (the shipped defaults adapt instead)
            for rule in slo_rules:
                if rule.window_s > window_s + 1e-9:
                    raise ValueError(
                        f"SLO rule {rule.name!r} window_s="
                        f"{rule.window_s} exceeds this scope's metric "
                        f"ring capacity (window_s={window_s}); raise "
                        "Telemetry(window_s=...) or shrink the rule "
                        "window")
        self.slo_rules = slo_rules
        self.slo_watchdog: Any = None
        self.exporter: Optional[SnapshotExporter] = None
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
        if self.export_interval_s is not None:
            # lazy: core.slo imports this module for the metric catalog
            from sparkdl_tpu_torch.core import slo as _slo

            rules = self.slo_rules
            if rules is None:
                cap = self.metrics.window_s
                if cap is not None and cap < _slo.DEFAULT_WINDOW_S:
                    # the defaults adapt to a smaller ring
                    rules = _slo.default_rules(window_s=cap)
                else:
                    rules = _slo.DEFAULT_RULES
            self.slo_watchdog = _slo.SLOWatchdog(rules) if rules else None
            self.exporter = SnapshotExporter(
                self, self.export_interval_s, out_dir=self.out_dir,
                watchdog=self.slo_watchdog)
            self.exporter.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        global _active
        if self.exporter is not None:
            # stop, then the final flush BEFORE deactivating: SLO events
            # of the last evaluation still mirror into this scope
            self.exporter.close()
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
        suffix = _scope_suffix(self)
        trace_path = os.path.join(out_dir,
                                  f"sparkdl_trace_{self.run_id}{suffix}.json")
        tmp = f"{trace_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.tracer.chrome_trace(), f)
        os.replace(tmp, trace_path)
        report = self.report()
        report["chrome_trace"] = trace_path
        report_path = os.path.join(
            out_dir, f"sparkdl_run_report_{self.run_id}{suffix}.json")
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
            bounds: Sequence[float] = DEFAULT_TIME_BOUNDS,
            exemplar: Optional[SpanContext] = None) -> None:
    """Record one histogram observation on the active registry, optionally
    tagged with the span context that produced it (kept only by scopes
    armed with ``exemplar_k``)."""
    tel = _active
    if tel is not None:
        tel.metrics.histogram(name, bounds).observe(value, exemplar)


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
            # the live plane's view of the same run: one compact entry
            # per periodic snapshot (None without an exporter)
            "timeline": (tel.exporter.timeline_summary()
                         if tel.exporter is not None else None),
        }
