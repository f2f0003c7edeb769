"""Cross-worker observability merge for the cluster inference plane.

The port of ``sparkdl_tpu.cluster.aggregate``.

A cluster run is N worker processes, each with its OWN telemetry scope
(``Telemetry(run_id=...)`` pinned to the coordinator's run id) and its
own :class:`~sparkdl_tpu_torch.core.health.HealthMonitor`. Without a merge
step, the operator story regresses to N disjoint black boxes — the
exact failure mode the single-process ``RunReport`` was built to
prevent. This module is the merge step: each worker builds ONE
end-of-run snapshot (:func:`build_snapshot`, shipped over its private
result pipe as the last message before EOF) and the coordinator folds
the snapshots into a single ``cluster`` section
(:func:`merge_snapshots`) or a full merged run report
(:func:`merged_run_report`).

Two accounting paths exist for health counts — the worker's monitor
counters and the ``sparkdl.health.<event>`` metric mirrors
:func:`sparkdl_tpu_torch.core.health.record` writes through one choke point —
and the merge cross-checks them (``health_consistent``): equality is
*proven* per merge, not assumed, so a divergence (a worker recording
outside its scopes) is visible in the report instead of silently
producing two different truths.

A worker's snapshot also carries its ``device`` section: the kernel
launch counts of that process (``kernels.launches`` lives in each
worker), its forwards and captures, its boot times and its
``torch.cuda.memory_reserved()``; :func:`merge_snapshots` sums the
launches and forwards over the workers.

Standard library and ``core.telemetry`` only.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.core import telemetry

__all__ = ["build_snapshot", "merge_snapshots", "merged_run_report",
           "sum_canonical_counters", "sum_health_counters",
           "sum_device_counts",
           "build_frame", "ClusterMetricsView"]


def build_snapshot(worker: str, pid: int, tel: Any, monitor: Any, *,
                   tasks: int, rows: int, exec_s: float,
                   phases: Optional[Dict[str, Any]] = None,
                   span_ring: Optional[Dict[str, Any]] = None,
                   serving: Optional[Dict[str, Any]] = None,
                   device: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """One worker's end-of-run snapshot (worker-side, while its
    telemetry scope and health monitor are still active): the same
    ingredients ``RunReport.build`` uses, JSON-able, small enough to
    ship over the result pipe. With cross-process tracing armed,
    ``span_ring`` is :meth:`Tracer.export_ring`'s shippable view of the
    worker's spans (rebased onto the coordinator's clock); the key is
    absent entirely when tracing is off, keeping the off-path snapshot
    byte-identical. ``serving`` is the worker's serving replica
    (``WorkerServingPlane.stats``; absent when it served nothing). ``device``
    is the worker's kernel launch counts, forwards, captures, boot
    times and reserved card memory."""
    snap = {
        "worker": worker,
        "pid": pid,
        "run_id": tel.run_id,
        "tasks": tasks,
        "rows": rows,
        "exec_s": round(exec_s, 6),
        "metrics": tel.metrics.snapshot(),
        "health": monitor.report(),
        "trace": tel.tracer.summary(),
        "phases": dict(phases or {}),
    }
    tenants = _tenant_section(snap["metrics"])
    if tenants:
        snap["tenants"] = tenants
    if span_ring is not None:
        snap["span_ring"] = span_ring
    if serving is not None:
        snap["serving"] = serving
    if device is not None:
        snap["device"] = device
    return snap


def _tenant_section(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Per-tenant queue-wait view, derived from the per-tenant histogram
    series ``core/executor.py`` emits (``sparkdl.executor.queue_wait_s.
    <tenant>``). Empty — and the section absent — when no non-default
    tenant ran, keeping single-tenant snapshots byte-identical."""
    prefix = telemetry.M_QUEUE_WAIT_S + "."
    out: Dict[str, Any] = {}
    for name, hist in ((metrics or {}).get("histograms") or {}).items():
        if name.startswith(prefix):
            out[name[len(prefix):]] = {
                "count": hist.get("count", 0),
                "sum_s": hist.get("sum", 0.0),
                "p99_s": hist.get("p99"),
                # the raw per-bucket counts (plus the observed envelope)
                # ride along so the coordinator's merge can estimate the
                # CLUSTER p99 from one merged bucket array instead of
                # taking the worst worker's estimate
                "buckets": hist.get("buckets") or {},
                "min_s": hist.get("min"),
                "max_s": hist.get("max"),
            }
    return dict(sorted(out.items()))


def _merged_bucket_percentile(views: Sequence[Dict[str, Any]],
                              q: float = 0.99) -> Optional[float]:
    """Estimate one percentile over the SUM of several workers' bucket
    dicts (``Histogram.snapshot()`` format: per-bucket counts keyed by
    the ``repr`` of the upper bound, ``"+Inf"`` for overflow), assuming
    the default time ladder. Returns ``None`` when any view lacks
    buckets or carries a bound off the ladder — the caller falls back
    to the worst-worker estimate rather than merging unlike ladders."""
    bounds = telemetry.DEFAULT_TIME_BOUNDS
    counts = [0] * (len(bounds) + 1)
    count = 0
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    for view in views:
        buckets = view.get("buckets")
        if not buckets:
            if view.get("count"):
                return None  # samples without bucket data: cannot merge
            continue
        for key, c in buckets.items():
            if key == "+Inf":
                idx = len(bounds)
            else:
                try:
                    bound = float(key)
                except (TypeError, ValueError):
                    return None
                idx = bisect.bisect_left(bounds, bound)
                if idx >= len(bounds) or bounds[idx] != bound:
                    return None  # off-ladder bound: unmergeable
            counts[idx] += int(c)
            count += int(c)
        lo, hi = view.get("min_s"), view.get("max_s")
        if lo is not None:
            vmin = lo if vmin is None else min(vmin, lo)
        if hi is not None:
            vmax = hi if vmax is None else max(vmax, hi)
    return telemetry._estimate_percentile(q, counts, count, bounds,
                                          vmin, vmax)


def sum_canonical_counters(snapshots: Sequence[Dict[str, Any]]
                           ) -> Dict[str, float]:
    """Sum each worker's counter metrics, restricted to the canonical
    catalog plus the ``sparkdl.health.*`` mirrors — ad-hoc counters stay
    in the per-worker sections, so the cluster-wide totals only ever
    contain names the taxonomy lint enforces."""
    totals: Dict[str, float] = {}
    for snap in snapshots:
        counters = (snap.get("metrics") or {}).get("counters") or {}
        for name, value in counters.items():
            if (name in telemetry.CANONICAL_METRIC_NAMES
                    or name.startswith(telemetry.HEALTH_METRIC_PREFIX)):
                totals[name] = totals.get(name, 0) + value
    return dict(sorted(totals.items()))


def sum_health_counters(snapshots: Sequence[Dict[str, Any]]
                        ) -> Dict[str, int]:
    """Sum the worker HealthMonitor counters across snapshots — the
    monitor-side accounting path, kept independent of the metric
    mirrors so :func:`merge_snapshots` can cross-check the two."""
    totals: Dict[str, int] = {}
    for snap in snapshots:
        counters = (snap.get("health") or {}).get("counters") or {}
        for name, value in counters.items():
            totals[name] = totals.get(name, 0) + value
    return dict(sorted(totals.items()))


def sum_device_counts(snapshots: Sequence[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Sum the workers' ``device`` sections: kernel launches, launches
    by body, forwards and captures."""
    launches: Dict[str, int] = {}
    by_body: Dict[str, Dict[str, int]] = {}
    forwards = captures = 0
    for snap in snapshots:
        dev = snap.get("device") or {}
        for name, n in (dev.get("launches") or {}).items():
            launches[name] = launches.get(name, 0) + int(n)
        for name, bodies in (dev.get("launches_by_body") or {}).items():
            agg = by_body.setdefault(name, {})
            for body, n in bodies.items():
                agg[body] = agg.get(body, 0) + int(n)
        forwards += int(dev.get("forwards", 0))
        captures += int(dev.get("captures", 0))
    return {"launches": dict(sorted(launches.items())),
            "launches_by_body": {k: dict(sorted(v.items()))
                                 for k, v in sorted(by_body.items())},
            "forwards": forwards, "captures": captures}


def merge_snapshots(snapshots: Sequence[Dict[str, Any]],
                    lost_workers: Sequence[str] = (),
                    autoscale_events: Sequence[Dict[str, Any]] = ()
                    ) -> Dict[str, Any]:
    """Fold per-worker snapshots into ONE ``cluster`` report section.

    Per-worker sections survive verbatim under ``workers`` (debugging a
    sick worker needs its un-summed view), canonical counters are
    summed cluster-wide, and the merged health counters are the sum of
    the worker monitors — with ``health_consistent`` proving that sum
    equals the independently-accumulated ``sparkdl.health.*`` metric
    mirrors, event for event.

    With cross-process tracing armed (any snapshot carrying a
    ``span_ring``), a ``trace`` subsection records spans shipped and
    dropped PER WORKER — ring truncation is visible in the report, not
    silent — plus one ``span_rings_lost`` entry per worker that died
    without shipping its final snapshot (``lost_workers``, from the
    router). Off-path reports keep their exact pre-tracing shape.

    With the elastic-capacity plane active, ``autoscale_events`` (the
    router's ordered spawn/drain ledger) becomes an ``autoscale``
    subsection — the event list verbatim plus scale-up/scale-down/drain
    tallies — and any per-tenant queue-wait series in the worker
    snapshots merge into a ``tenants`` subsection (counts summed;
    ``p99_s`` is the WORST worker's p99, since percentiles cannot be
    merged exactly across independent histograms). Both keys are absent
    when the features are off.

    With the cluster serving plane active (any snapshot carrying a
    ``serving`` section), a ``serving`` subsection folds the per-worker
    replica stats together: predicts/errors summed, plus the
    worker-side replica map ``{model: {version: [workers deployed]}}``
    — the router enriches it at close with its coordinator-side view
    (``serving.router``: routing, failovers, cutovers). Absent when no
    worker served.
    """
    snapshots = [s for s in snapshots if s]
    health_totals = sum_health_counters(snapshots)
    counters = sum_canonical_counters(snapshots)
    prefix = telemetry.HEALTH_METRIC_PREFIX
    mirrored = {name[len(prefix):]: int(value)
                for name, value in counters.items()
                if name.startswith(prefix)}
    out = {
        "worker_count": len(snapshots),
        "workers": {s["worker"]: s for s in snapshots},
        "counters": counters,
        "health": {"counters": health_totals},
        "health_consistent": mirrored == health_totals,
        "tasks_per_worker": {s["worker"]: s.get("tasks", 0)
                             for s in snapshots},
        "rows_per_worker": {s["worker"]: s.get("rows", 0)
                            for s in snapshots},
        "exec_s_per_worker": {s["worker"]: s.get("exec_s", 0.0)
                              for s in snapshots},
    }
    if any(s.get("device") is not None for s in snapshots):
        out["device"] = sum_device_counts(snapshots)
    if any(s.get("span_ring") is not None for s in snapshots):
        out["trace"] = {
            "workers": {
                s["worker"]: {
                    "shipped": len(s["span_ring"]["spans"]),
                    "dropped": s["span_ring"]["dropped"],
                    "clock_offset_ns": s["span_ring"]["clock_offset_ns"],
                }
                for s in snapshots if s.get("span_ring") is not None},
            "span_rings_lost": sorted(lost_workers),
        }
    tenants: Dict[str, Dict[str, Any]] = {}
    tenant_views: Dict[str, List[Dict[str, Any]]] = {}
    for s in snapshots:
        for tenant, view in (s.get("tenants") or {}).items():
            agg = tenants.setdefault(
                tenant, {"count": 0, "sum_s": 0.0, "p99_s": None,
                         "p99_worst_worker": None})
            agg["count"] += view.get("count", 0)
            agg["sum_s"] = round(agg["sum_s"] + view.get("sum_s", 0.0), 9)
            p99 = view.get("p99_s")
            if p99 is not None and (agg["p99_worst_worker"] is None
                                    or p99 > agg["p99_worst_worker"]):
                agg["p99_worst_worker"] = p99
            tenant_views.setdefault(tenant, []).append(view)
    for tenant, agg in tenants.items():
        # the cluster p99 is a REAL merged percentile (bucket counts
        # summed across workers, one estimate over the sum); the old
        # worst-worker value stays published as p99_worst_worker for one
        # release of comparability, and is the fallback when a worker
        # shipped no bucket data to merge
        merged = _merged_bucket_percentile(tenant_views[tenant], q=0.99)
        agg["p99_s"] = (merged if merged is not None
                        else agg["p99_worst_worker"])
    if tenants:
        out["tenants"] = dict(sorted(tenants.items()))
    serving_workers = {s["worker"]: s["serving"] for s in snapshots
                       if s.get("serving") is not None}
    if serving_workers:
        replicas: Dict[str, Dict[str, List[str]]] = {}
        for wname, srv in serving_workers.items():
            for dep in srv.get("deployments", ()):
                versions = replicas.setdefault(dep["model"], {})
                versions.setdefault(dep["version"], []).append(wname)
        out["serving"] = {
            "workers": serving_workers,
            "predicts": sum(s.get("predicts", 0)
                            for s in serving_workers.values()),
            "errors": sum(s.get("errors", 0)
                          for s in serving_workers.values()),
            "replicas": {m: {v: sorted(ws) for v, ws in sorted(vs.items())}
                         for m, vs in sorted(replicas.items())},
        }
    if autoscale_events:
        events = [dict(e) for e in autoscale_events]
        out["autoscale"] = {
            "events": events,
            "scale_ups": sum(1 for e in events
                             if e.get("action") == "spawn"
                             and e.get("reason") == "scale_up"),
            "scale_downs": sum(1 for e in events
                               if e.get("action") == "draining"
                               and e.get("reason") == "scale_down"),
            "drained": sum(1 for e in events
                           if e.get("action") == "drained"),
        }
    return out


def merged_run_report(tel: Any, snapshots: Sequence[Dict[str, Any]],
                      health_monitor: Any = None,
                      lost_workers: Sequence[str] = (),
                      autoscale_events: Sequence[Dict[str, Any]] = ()
                      ) -> Dict[str, Any]:
    """The coordinator's normal ``RunReport`` plus the merged
    ``cluster`` section — one artifact for the whole cluster run."""
    report = telemetry.RunReport.build(tel, health_monitor)
    report["cluster"] = merge_snapshots(snapshots,
                                        lost_workers=lost_workers,
                                        autoscale_events=autoscale_events)
    return report


# ---------------------------------------------------------------------------
# Live metrics federation: workers ship bounded windowed-metrics frames at the
# federation cadence; the coordinator folds them into ONE live view.
# ---------------------------------------------------------------------------


def build_frame(worker: str, wid: int, seq: int, tel: Any,
                clock_offset_ns: int = 0) -> Optional[Dict[str, Any]]:
    """One worker's metrics-federation frame (worker-side, between
    tasks): ``MetricsRegistry.export_frame()``'s canonical-name-filtered
    ring export plus the worker identity, a per-worker frame sequence
    number, and the clock-handshake offset the coordinator needs to
    rebase the slot epochs onto its own clock. ``None`` when the
    worker's registry has no windows (nothing to federate)."""
    frame = tel.metrics.export_frame()
    if frame is None:
        return None
    frame["worker"] = worker
    frame["wid"] = wid
    frame["seq"] = seq
    frame["clock_offset_ns"] = int(clock_offset_ns)
    return frame


class ClusterMetricsView:
    """The coordinator's live fold of worker metrics frames.

    Each :func:`build_frame` payload is the full state of one worker's
    metric rings (merge-by-replace per worker: a dropped frame heals on
    the next cadence). The fold happens at QUERY time —
    :meth:`window_snapshot` walks the retained frames, rebases every
    slot epoch onto the coordinator's clock (the per-worker slot shift
    is ``round(clock_offset / slot_span)``, from the clock
    handshake, so a skewed worker's samples land in the coordinator
    slots they actually happened in: no double-count, no gap), sums
    counters, merges gauge envelopes, and SUMS histogram bucket arrays
    per slot — a cluster p99 is one estimate over the merged buckets,
    not a worst-worker guess.

    Staleness: a worker whose last frame is older than
    ``stale_factor × cadence_s`` — or that the router marked dead — is
    aged OUT of the fold, and ``workers_reporting`` says so explicitly.
    Its last frame is retained (not folded) so a postmortem bundle can
    still show the dead worker's final shipped state.

    The view quacks like a :class:`telemetry.MetricsRegistry` for the
    SLO watchdog: ``window_snapshot(window_s)`` returns the exact
    windowed shape ``SLOWatchdog.evaluate`` consumes, so a plain
    watchdog evaluates cluster-level rules against it unchanged.

    Thread-safe: the router's collector ingests while the exporter
    thread (and tests) query.
    """

    #: Exemplars kept per merged histogram window (the per-worker
    #: reservoirs are already tiny; the merge keeps the global tail).
    MERGED_EXEMPLAR_K = 8

    def __init__(self, cadence_s: float, stale_factor: float = 3.0,
                 timeline_max: int = 240) -> None:
        if cadence_s <= 0:
            raise ValueError(
                f"federation cadence_s must be > 0, got {cadence_s!r}")
        self.cadence_s = float(cadence_s)
        self.stale_after_s = float(stale_factor) * self.cadence_s
        self._lock = threading.Lock()
        # worker name -> {frame, shift, last_seen, alive}
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._timeline: "deque[Dict[str, Any]]" = deque(
            maxlen=timeline_max)
        self.frames_ingested = 0
        self.window_s: Optional[float] = None  # ring capacity, learned

    # -- ingest (collector thread) -------------------------------------------

    def ingest(self, frame: Dict[str, Any],
               now: Optional[float] = None) -> None:
        """Fold one worker frame in (merge-by-replace for that worker).
        The slot shift is computed once here from the frame's shipped
        clock offset; sub-slot skew is absorbed by round-to-nearest."""
        span = float(frame.get("span_s") or 0.0)
        slots = int(frame.get("slots") or 0)
        worker = frame.get("worker")
        if span <= 0 or slots <= 0 or not worker:
            return
        if now is None:
            now = telemetry._monotonic()
        offset_s = float(frame.get("clock_offset_ns") or 0) / 1e9
        shift = int(math.floor(offset_s / span + 0.5))
        with self._lock:
            self._workers[worker] = {
                "frame": frame, "shift": shift, "last_seen": now,
                "alive": True}
            self.frames_ingested += 1
            self.window_s = span * slots

    def mark_dead(self, worker: str) -> None:
        """Age a dead worker out of the fold immediately (its pipe hit
        EOF — no more frames are coming); the last frame is retained
        for the flight recorder."""
        with self._lock:
            entry = self._workers.get(worker)
            if entry is not None:
                entry["alive"] = False

    # -- accounting ----------------------------------------------------------

    def _fresh_locked(self, now: float) -> List[Dict[str, Any]]:
        return [e for e in self._workers.values()
                if e["alive"] and now - e["last_seen"] <= self.stale_after_s]

    def workers_reporting(self, now: Optional[float] = None) -> int:
        """Workers currently IN the fold: alive (no EOF) and fresh
        (frame newer than the staleness horizon)."""
        if now is None:
            now = telemetry._monotonic()
        with self._lock:
            return len(self._fresh_locked(now))

    def fresh_workers(self, now: Optional[float] = None) -> List[str]:
        """The names behind :meth:`workers_reporting` — the router's
        collector diffs consecutive calls to emit one
        ``cluster_metrics_stale`` event per worker leaving the fold."""
        if now is None:
            now = telemetry._monotonic()
        with self._lock:
            return sorted(w for w, e in self._workers.items()
                          if e["alive"]
                          and now - e["last_seen"] <= self.stale_after_s)

    def last_frames(self) -> Dict[str, Dict[str, Any]]:
        """Every retained frame (fresh, stale, AND dead workers') with
        its accounting — the flight recorder's raw material."""
        with self._lock:
            return {w: {"frame": e["frame"], "alive": e["alive"],
                        "last_seen": e["last_seen"]}
                    for w, e in sorted(self._workers.items())}

    # -- the fold ------------------------------------------------------------

    def window_snapshot(self, window_s: Optional[float] = None,
                        now: Optional[float] = None) -> Dict[str, Any]:
        """The federated windowed view, in ``MetricsRegistry.
        window_snapshot`` shape (plus ``workers_reporting``) so the SLO
        watchdog, the autoscaler, and the exporter consume it like a
        local registry."""
        if now is None:
            now = telemetry._monotonic()
        with self._lock:
            entries = self._fresh_locked(now)
            reporting = len(entries)
            cap = self.window_s
        if window_s is None:
            window_s = cap
        if cap is not None and window_s is not None:
            window_s = min(float(window_s), cap)
        out = self._fold(entries, window_s, now)
        out["workers_reporting"] = reporting
        return out

    def attribution(self, metric: str, stat: str,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> Dict[str, Any]:
        """Per-worker observed values for one metric/stat over the
        window — what a federated breach event carries so the operator
        sees WHICH workers drove the cluster-wide verdict."""
        if now is None:
            now = telemetry._monotonic()
        with self._lock:
            entries = {w: e for w, e in sorted(self._workers.items())
                       if e["alive"]
                       and now - e["last_seen"] <= self.stale_after_s}
        out: Dict[str, Any] = {}
        for worker, entry in entries.items():
            folded = self._fold([entry], window_s, now)
            hist = folded["histograms"].get(metric)
            ctr = folded["counters"].get(metric)
            gauge = folded["gauges"].get(metric)
            if hist is not None and stat in hist:
                out[worker] = hist[stat]
            elif ctr is not None and stat in ctr:
                out[worker] = ctr[stat]
            elif gauge is not None and stat == "value":
                out[worker] = gauge["last"]
            else:
                out[worker] = None
        return out

    def _fold(self, entries: Sequence[Dict[str, Any]],
              window_s: Optional[float], now: float) -> Dict[str, Any]:
        if not entries or not window_s or window_s <= 0:
            return {"window_s": window_s if window_s else None,
                    "counters": {}, "gauges": {}, "histograms": {}}
        span = float(entries[0]["frame"]["span_s"])
        slots = int(entries[0]["frame"]["slots"])
        # the coordinator-clock window floor — the same arithmetic as
        # telemetry._window_floor, but over the query clock so fakes in
        # tests drive it deterministically
        k = min(slots, max(1, math.ceil(window_s / span)))
        floor = int(now / span) - k + 1
        counters: Dict[str, int] = {}
        gauges: Dict[str, List[Tuple[int, List[float]]]] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for entry in entries:
            frame, shift = entry["frame"], entry["shift"]
            for name, per_slot in (frame.get("counters") or {}).items():
                for epoch, c in per_slot.items():
                    if int(epoch) + shift >= floor:
                        counters[name] = counters.get(name, 0) + int(c)
            for name, per_slot in (frame.get("gauges") or {}).items():
                for epoch, env in per_slot.items():
                    if int(epoch) + shift >= floor:
                        gauges.setdefault(name, []).append(
                            (int(epoch) + shift, list(env)))
            for name, hist in (frame.get("histograms") or {}).items():
                bounds = tuple(float(b) for b in hist.get("bounds") or ())
                agg = hists.setdefault(name, {
                    "bounds": bounds,
                    "counts": [0] * (len(bounds) + 1),
                    "count": 0, "sum": 0.0, "min": None, "max": None,
                    "exemplars": []})
                if agg["bounds"] != bounds:
                    continue  # unlike ladders never merge
                for epoch, slot in (hist.get("slots") or {}).items():
                    if int(epoch) + shift < floor:
                        continue
                    bucket_counts, cnt, total, lo, hi = slot[:5]
                    for j, c in enumerate(bucket_counts):
                        agg["counts"][j] += c
                    agg["count"] += cnt
                    agg["sum"] += total
                    if lo is not None:
                        agg["min"] = (lo if agg["min"] is None
                                      else min(agg["min"], lo))
                    if hi is not None:
                        agg["max"] = (hi if agg["max"] is None
                                      else max(agg["max"], hi))
                    if len(slot) > 5:
                        agg["exemplars"].extend(
                            tuple(ex) for ex in slot[5])
        out_counters = {
            name: {"count": c, "rate_per_s": round(c / window_s, 9)}
            for name, c in sorted(counters.items())}
        out_gauges: Dict[str, Any] = {}
        for name, seen in sorted(gauges.items()):
            seen.sort(key=lambda ev: ev[0])
            out_gauges[name] = {
                "last": seen[-1][1][0],
                "min": min(env[1] for _, env in seen),
                "max": max(env[2] for _, env in seen)}
        out_hists: Dict[str, Any] = {}
        for name, agg in sorted(hists.items()):
            count = agg["count"]
            snap = {
                "count": count,
                "sum": round(agg["sum"], 9),
                "rate_per_s": round(count / window_s, 9),
                "min": agg["min"], "max": agg["max"],
            }
            for stat, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
                snap[stat] = telemetry._estimate_percentile(
                    q, agg["counts"], count, agg["bounds"],
                    agg["min"], agg["max"])
            if agg["exemplars"]:
                exemplars = sorted(agg["exemplars"], reverse=True)
                snap["exemplars"] = [
                    {"value": v, "trace_id": t, "span_id": s}
                    for v, t, s in exemplars[:self.MERGED_EXEMPLAR_K]]
            out_hists[name] = snap
        return {"window_s": float(window_s), "counters": out_counters,
                "gauges": out_gauges, "histograms": out_hists}

    # -- the bounded timeline the flight recorder dumps ----------------------

    def note_timeline(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._timeline.append(entry)

    def timeline(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._timeline)

    # -- exporter integration ------------------------------------------------

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The compact per-tick view the coordinator's snapshot exporter
        embeds (``cluster`` key of each JSONL line): accounting plus the
        non-empty folded instruments."""
        if now is None:
            now = telemetry._monotonic()
        snap = self.window_snapshot(now=now)
        with self._lock:
            known = len(self._workers)
            ingested = self.frames_ingested
        return {
            "workers_reporting": snap["workers_reporting"],
            "workers_known": known,
            "frames_ingested": ingested,
            "window_s": snap["window_s"],
            "counters": {k: v for k, v in snap["counters"].items()
                         if v["count"]},
            "gauges": snap["gauges"],
            "histograms": {
                k: {"count": v["count"], "p50": v["p50"],
                    "p99": v["p99"]}
                for k, v in snap["histograms"].items() if v["count"]},
        }

    def prometheus_text(self, now: Optional[float] = None) -> str:
        """Federated Prometheus series (``sparkdl_cluster_*`` prefix so
        they never collide with the coordinator's local families): the
        merged windowed percentiles/rates plus the reporting gauge —
        what makes a live scrape of the coordinator reflect the whole
        cluster."""
        import re as _re

        snap = self.window_snapshot(now=now)
        lines: List[str] = []

        def family(name: str, kind: str) -> str:
            n = "sparkdl_cluster:" + _re.sub(r"[^a-zA-Z0-9_:]", "_", name)
            lines.append(f"# HELP {n} federated cluster view of {name} "
                         f"(sparkdl_tpu {kind})")
            lines.append(f"# TYPE {n} {kind}")
            return n

        n = family("workers_reporting", "gauge")
        lines.append(f"{n} {snap['workers_reporting']}")
        for name, view in snap["counters"].items():
            n = family(name + ":window_rate_per_s", "gauge")
            lines.append(f"{n} {view['rate_per_s']}")
        for name, view in snap["gauges"].items():
            n = family(name, "gauge")
            lines.append(f"{n} {view['last']}")
        for name, view in snap["histograms"].items():
            for stat in ("p50", "p99"):
                if view[stat] is None:
                    continue
                n = family(f"{name}:window_{stat}", "gauge")
                lines.append(f"{n} {view[stat]}")
        return "\n".join(lines) + "\n"
