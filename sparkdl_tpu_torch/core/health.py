"""Run-health telemetry: counters and events for the supervision layers.

A port of ``sparkdl_tpu.core.health``. Every layer that degrades or
recovers (the data plane's decode degradation, the staging pipeline's
per-stream report, and, as they are ported, retries, re-chunking and
restarts) reports what it did into one :class:`HealthMonitor`, so a
run's operator can answer "what went wrong, and what did the framework
do about it?" from one structured report instead of grepping warnings.

Monitors activate process-wide (partition ops may run on other threads,
where a ContextVar scope entered on the calling thread would be
invisible), nest, and restore the previous monitor on exit. With no active monitor,
:func:`record` is one global read and a ``None`` check — the hot paths
pay nothing when nobody is listening.

Standard library only (and the port's telemetry core): every layer may
import it without cycles. The event names are the reference's, those of
layers not ported yet included, so reports of the two packages compare
name for name.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.core import telemetry

logger = logging.getLogger(__name__)

# Canonical event names fed by the framework's own layers. Callers may
# record arbitrary additional events; these are the ones the docs and the
# chaos suite key off.
TASK_STARTED = "task_started"            # engine: a partition task began
TASK_RETRIED = "task_retried"            # engine: classified-retryable retry
TASK_FAILED = "task_failed"              # engine: terminal task failure
TASK_HEDGED = "task_hedged"              # engine: straggler duplicate launched
HEDGE_WON = "hedge_won"                  # engine: the duplicate finished first
TASK_QUARANTINED = "task_quarantined"    # engine: poisoned partition dropped
TASK_DEADLINE_EXCEEDED = "task_deadline_exceeded"  # engine: watchdog fired
CHUNK_RETRY = "chunk_retry"              # batching: transient chunk retry
OOM_RECHUNK = "oom_rechunk"              # batching: bucket-halving fallback
GANG_RESTART = "gang_restart"            # runner: classified gang restart
GANG_FATAL = "gang_fatal"                # runner: fatal/OOM raise, no restart
GANG_FAILED = "gang_failed"              # runner: restart budget exhausted
FIT_RESUMED = "fit_resumed"              # trainer: resumed from a checkpoint
FIT_COMPLETED = "fit_completed"          # trainer: fit loop finished
DECODE_DEGRADED = "decode_degraded"      # data plane: row degraded to null
DECODE_POOL_RESPAWN = "decode_pool_respawn"  # decode pool: worker process
                                         # died and was respawned
PREFETCH_REPORT = "prefetch_report"      # pipeline: per-stream staging summary
                                         # (staged/stalls/stall_s/max_depth)
EXECUTOR_SHED = "executor_shed"          # executor: admission shed a request
EXECUTOR_DEADLINE_SHED = "executor_deadline_shed"  # executor: request
                                         # expired in queue, dropped pre-launch
BREAKER_OPEN = "breaker_open"            # executor: circuit breaker tripped
BREAKER_PROBE = "breaker_probe"          # executor: half-open probe admitted
BREAKER_CLOSED = "breaker_closed"        # executor: probe succeeded, recovered
SLO_BREACH = "slo_breach"                # slo: rule held in breach past its
                                         # hold-down (paired with recovery)
SLO_RECOVERED = "slo_recovered"          # slo: breached rule back in budget
TELEMETRY_EXPORT_ERROR = "telemetry_export_error"  # telemetry: exporter
                                         # tick crashed (skipped, not fatal)
DURABLE_RESUMED = "durable_resumed"      # durability: a journal with
                                         # committed partitions was resumed
DURABLE_PARTITION_RESTORED = "durable_partition_restored"  # durability:
                                         # committed partition loaded from
                                         # spill instead of recomputed
DURABLE_JOURNAL_TORN = "durable_journal_torn"  # durability: torn/corrupt
                                         # journal record or spill hash
                                         # mismatch discarded, not trusted
DECODE_POOL_SHM_SWEPT = "decode_pool_shm_swept"  # decode pool: orphaned
                                         # segment of a dead owner unlinked
CHECKPOINT_CHECKSUM_REJECTED = "checkpoint_checksum_rejected"  # checkpoint:
                                         # restore refused a bit-rotted file
CHECKPOINT_FENCED = "checkpoint_fenced"  # checkpoint: stale-incarnation
                                         # writer refused by fencing token
SERVING_SHED = "serving_shed"            # serving: SLO-aware admission
                                         # rejected a request pre-device
SERVING_CUTOVER = "serving_cutover"      # serving: active version flipped
                                         # (deploys AND rollbacks)
SERVING_SHADOW_COMPARED = "serving_shadow_compared"  # serving: one shadow
                                         # request compared vs active
SERVING_SHADOW_ERROR = "serving_shadow_error"  # serving: shadow leg raised
                                         # (never fails the request)
SERVING_EVICTED = "serving_evicted"      # serving: residency dropped a
                                         # model's weights + jit state
SERVING_COLD_START = "serving_cold_start"  # serving: loader ran on a
                                         # residency miss (first load OR
                                         # reload after eviction)
SERVING_FAILOVER = "serving_failover"    # serving: one in-flight predict
                                         # re-admitted to a surviving
                                         # replica after its worker died
                                         # (exactly one event per moved
                                         # request)
SERVING_PREPARE_FAILED = "serving_prepare_failed"  # serving: a cluster
                                         # cutover's prepare phase failed
                                         # on some worker — rolled back,
                                         # v1 still serving everywhere
WARMUP_COMPLETED = "warmup_completed"    # serving: a deployment's full
                                         # bucket ladder was AOT-compiled
                                         # (and kernel shootouts settled)
                                         # before it took traffic
CLUSTER_WORKER_STARTED = "cluster_worker_started"  # cluster: a worker
                                         # process was spawned
CLUSTER_WORKER_LOST = "cluster_worker_lost"  # cluster: a worker died
                                         # (EOF on its result pipe)
CLUSTER_REDISPATCH = "cluster_redispatch"  # cluster: a dead worker's
                                         # in-flight partition re-sent
                                         # to a survivor
CLUSTER_SCALE_UP = "cluster_scale_up"    # cluster: autoscaler spawned a
                                         # worker under queue pressure
CLUSTER_SCALE_DOWN = "cluster_scale_down"  # cluster: autoscaler retired
                                         # an idle worker via drain
CLUSTER_WORKER_DRAINING = "cluster_worker_draining"  # cluster: a worker
                                         # stopped taking dispatches
                                         # (preemption warning or
                                         # scale-down order)
CLUSTER_WORKER_DRAINED = "cluster_worker_drained"  # cluster: a draining
                                         # worker finished its in-flight
                                         # tasks and exited cleanly
CLUSTER_PREEMPTION_NOTICE = "cluster_preemption_notice"  # cluster: a
                                         # worker reported SIGTERM-with-
                                         # warning (spot-VM preemption)
CLUSTER_METRICS_STALE = "cluster_metrics_stale"  # cluster: a worker's
                                         # federation frames aged out of
                                         # the live fold (stale or dead)
POSTMORTEM_DUMPED = "postmortem_dumped"  # cluster: the flight recorder
                                         # wrote a breach/death-triggered
                                         # postmortem bundle
TENANT_THROTTLED = "tenant_throttled"    # executor: fair queueing held a
                                         # tenant's requests back while
                                         # another tenant's were released


class HealthMonitor:
    """Thread-safe per-run counters + a bounded structured event log.

    ::

        with HealthMonitor("nightly-fit") as mon:
            pipeline.run()
        report = mon.report()          # {'counters': {...}, ...}
        assert mon.count("task_retried") == 1

    Counters are unbounded (one int per event name); the event log keeps
    the first ``max_events`` events with their context kwargs and counts
    the overflow, so a pathological retry storm cannot exhaust memory.
    """

    def __init__(self, name: str = "run", max_events: int = 2048) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._events: List[Dict[str, Any]] = []
        self._max_events = max_events
        self._dropped_events = 0
        self._dropped_by_event: Dict[str, int] = {}
        self._prev: Optional["HealthMonitor"] = None

    # -- recording -----------------------------------------------------------

    def record(self, event: str, n: int = 1, **ctx: Any) -> None:
        """Count ``event`` (``n`` occurrences) and log one context entry.
        Overflow past ``max_events`` is never silent: the drop is counted
        (total and per event name) and surfaced in :meth:`report`."""
        with self._lock:
            self._counters[event] = self._counters.get(event, 0) + n
            if len(self._events) < self._max_events:
                entry: Dict[str, Any] = {"event": event}
                if n != 1:
                    entry["n"] = n
                entry.update(ctx)
                self._events.append(entry)
            else:
                self._dropped_events += 1
                self._dropped_by_event[event] = \
                    self._dropped_by_event.get(event, 0) + 1

    # -- querying ------------------------------------------------------------

    def count(self, event: str) -> int:
        with self._lock:
            return self._counters.get(event, 0)

    def dropped_events(self) -> int:
        """Events the bounded log overflowed (counters stay exact)."""
        with self._lock:
            return self._dropped_events

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if event is None:
                return list(self._events)
            return [e for e in self._events if e["event"] == event]

    def quarantined(self) -> List[Dict[str, Any]]:
        """The quarantine registry: one entry per dropped partition."""
        return self.events(TASK_QUARANTINED)

    def report(self) -> Dict[str, Any]:
        """The per-run health report (structured, JSON-able)."""
        with self._lock:
            return {
                "run": self.name,
                "counters": dict(sorted(self._counters.items())),
                "quarantined": [e for e in self._events
                                if e["event"] == TASK_QUARANTINED],
                "events_recorded": len(self._events),
                "events_dropped": self._dropped_events,
                "events_dropped_by_event": dict(
                    sorted(self._dropped_by_event.items())),
            }

    def log_report(self, level: int = logging.INFO) -> None:
        rep = self.report()
        if not rep["counters"]:
            logger.log(level, "health report for %r: no events recorded",
                       self.name)
            return
        counters = ", ".join(f"{k}={v}" for k, v in rep["counters"].items())
        logger.log(level, "health report for %r: %s (%d event(s) recorded"
                   "%s)", self.name, counters, rep["events_recorded"],
                   f", {rep['events_dropped']} dropped"
                   if rep["events_dropped"] else "")

    # -- activation ----------------------------------------------------------

    def __enter__(self) -> "HealthMonitor":
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
        # Job-end hook: one report per run, when the monitor deactivates.
        if self._counters:
            self.log_report()


_active: Optional[HealthMonitor] = None
_activation_lock = threading.Lock()


def active_monitor() -> Optional[HealthMonitor]:
    return _active


def record(event: str, n: int = 1, **ctx: Any) -> None:
    """Record into the active monitor (no-op — one global read — without
    one). Every record is also mirrored into the active telemetry
    scope's metrics registry as the counter
    ``sparkdl.health.<event>`` — one choke point, so the run report's
    metric snapshot and the HealthMonitor counts agree exactly."""
    mon = _active
    if mon is not None:
        mon.record(event, n=n, **ctx)
    if telemetry.active() is not None:
        telemetry.count(telemetry.HEALTH_METRIC_PREFIX + event, n)


def log_report(level: int = logging.INFO) -> None:
    """Log the active monitor's report (no-op without one) — the
    job-end hook long pipelines call."""
    mon = _active
    if mon is not None:
        mon.log_report(level)
