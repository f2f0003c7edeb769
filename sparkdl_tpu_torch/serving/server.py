"""Row-level online request API over the executor choke point.

A port of ``sparkdl_tpu.serving.server``. ``ModelServer.predict(model,
rows, deadline_ms, priority)`` serves a single row or a small batch — NOT
an engine partition — and enters the device only through
:func:`sparkdl_tpu_torch.core.executor.execute`, so coalescing, priority
lanes, admission control, the per-model circuit breaker and deadline
propagation apply unchanged to online traffic.

What the serving layer ADDS on top of the executor:

- **SLO-aware admission.** Each deployment can carry a p99 latency
  target; before a request is admitted (and before its rows are staged),
  the windowed queue-wait p99 from the live telemetry plane is compared
  with the target's queue budget. Over budget: ``admission="shed"``
  (default) rejects with :class:`ServingOverloaded` and a
  ``serving_shed`` health event; ``admission="block"`` admits and lets
  the executor's backpressure and the request deadline bound the wait.
- **Target-driven coalesce window.** The same target caps how long a
  request may wait for coalescing siblings (a fraction of the target,
  passed per call as ``execute``'s ``coalesce_window_ms``).
- **Versioning.** The model name resolves through the
  :class:`~sparkdl_tpu_torch.serving.registry.ModelRegistry` at
  admission: responses always come from the active version, a configured
  fraction mirrors to the shadow version on the bulk lane (compared and
  recorded, never answering), and cutover/rollback are atomic pointer
  flips.
- **The cluster branch.** With ``EngineConfig.serving_cluster`` and
  ``cluster_workers`` set, :meth:`ModelServer.predict`,
  :meth:`~ModelServer.cutover` and :meth:`~ModelServer.rollback` go
  through ``serving/cluster.py``: replicas in the cluster workers,
  failover, and a cluster-atomic two-phase cutover. With no live replica
  a predict raises the classified ``ServingReplicaLost``; it is never
  answered in this process instead.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np

from sparkdl_tpu_torch.core import executor, health, resilience, telemetry
from sparkdl_tpu_torch.serving.registry import (
    ModelRegistry, default_registry,
)

# Fraction of a model's latency target spent on the coalesce window
# (the rest belongs to queue wait + the launch itself), and the ceiling
# matching the executor's own adaptive bound (_WINDOW_MAX_S).
_TARGET_WINDOW_FRACTION = 0.1
_TARGET_WINDOW_MAX_MS = 20.0
# Fraction of the latency target the QUEUE WAIT may consume before
# admission starts shedding: with queue-wait p99 above this, a new
# request would spend its whole budget waiting in line.
_QUEUE_WAIT_BUDGET_FRACTION = 0.5


class ServingOverloaded(RuntimeError):
    """SLO-aware admission rejected this request: the windowed
    queue-wait p99 already exceeds the model's latency budget, so
    serving it would blow its target AND push every queued sibling
    further over. Clients treat this as retry-with-backoff."""


def stage_rows(dep: Any, rows: Any):
    """Coerce a request payload to ``(batch, single)``: a single row
    (rank = the model's element rank) gains a batch dim here and loses
    it again in the response. Module-level, as in the reference, where
    the cluster plane's replicas stage the same way."""
    batch = np.asarray(rows)
    spec = getattr(dep.model(), "input_spec", None)
    shape = getattr(spec, "shape", None)
    single = shape is not None and batch.ndim == len(shape) - 1
    if single:
        batch = batch[None]
    if batch.shape[0] == 0:
        raise ValueError("predict() needs at least one row")
    return batch, single


def target_window_ms(dep: Any) -> Optional[float]:
    """The deployment's coalesce-window cap derived from its latency
    target (None = the executor's adaptive window)."""
    if dep.latency_target_ms is None:
        return None
    return min(dep.latency_target_ms * _TARGET_WINDOW_FRACTION,
               _TARGET_WINDOW_MAX_MS)


class PredictResult:
    """One answered request: the output, WHICH version answered, and
    the end-to-end latency (shadow comparison time included when this
    request was mirrored)."""

    __slots__ = ("output", "model", "version", "latency_s", "shadowed")

    def __init__(self, output: Any, model: str, version: str,
                 latency_s: float, shadowed: bool) -> None:
        self.output = output
        self.model = model
        self.version = version
        self.latency_s = latency_s
        self.shadowed = shadowed

    def __repr__(self) -> str:
        return (f"PredictResult(model={self.model!r}, "
                f"version={self.version!r}, "
                f"latency_s={self.latency_s:.4f}, "
                f"shadowed={self.shadowed})")


class ModelServer:
    """The online front-end. One instance per serving plane; stateless
    between requests except the in-flight depth gauge."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 admission: str = "shed",
                 slo_window_s: float = 10.0,
                 queue_wait_budget_frac: float =
                 _QUEUE_WAIT_BUDGET_FRACTION) -> None:
        if admission not in ("shed", "block"):
            raise ValueError(
                f"admission must be 'shed' or 'block', got {admission!r}")
        if slo_window_s <= 0:
            raise ValueError(
                f"slo_window_s must be > 0, got {slo_window_s!r}")
        if not 0.0 < queue_wait_budget_frac <= 1.0:
            raise ValueError(
                "queue_wait_budget_frac must be in (0, 1], got "
                f"{queue_wait_budget_frac!r}")
        self.registry = registry if registry is not None \
            else default_registry()
        self._admission = admission
        self._slo_window_s = slo_window_s
        self._queue_wait_budget_frac = queue_wait_budget_frac
        self._lock = threading.Lock()
        self._inflight = 0
        _servers.add(self)

    # -- the request path ----------------------------------------------------

    def predict(self, model: str, rows: Any, *,
                deadline_ms: Optional[float] = None,
                priority: str = executor.PRIORITY_INTERACTIVE,
                tenant: Optional[str] = None
                ) -> PredictResult:
        """Serve one row (rank = the model's element rank; the batch
        dim is added and squeezed back) or one small batch. Rides the
        interactive lane unless told otherwise; ``deadline_ms`` bounds
        queue wait, backpressure blocking and drain (the executor drops
        an expired request unlaunched). ``tenant`` is the fair-queueing
        tag: requests from different tenants share the executor under
        deficit-round-robin, and non-default tenants get their own
        queue-wait series + shed attribution (None resolves through the
        ambient ``executor.tenant_scope`` / EngineConfig default)."""
        t0 = time.monotonic()
        cluster = self._cluster()
        if cluster is not None:
            return self._predict_cluster(cluster, model, rows,
                                         deadline_ms=deadline_ms,
                                         priority=priority,
                                         tenant=tenant, t0=t0)
        active, shadow = self.registry.resolve(model)
        # shed BEFORE paying for staging / cold load
        self._admit(active, tenant=tenant)
        batch, single = stage_rows(active, rows)
        deadline = (resilience.Deadline(deadline_ms / 1e3)
                    if deadline_ms is not None else None)
        window_ms = target_window_ms(active)
        self._note_inflight(1)
        try:
            out = executor.execute(
                active.model(), batch, batch_size=active.batch_size,
                priority=priority, deadline=deadline,
                coalesce_window_ms=window_ms, tenant=tenant)
        finally:
            self._note_inflight(-1)
        shadowed = False
        if shadow is not None:
            active_s = time.monotonic() - t0
            # the request's span context rides into the shadow lane
            # explicitly: shadow work stays attributable to THIS request
            # even if the lane ever moves off the caller thread
            self._run_shadow(model, active, shadow, batch, out, active_s,
                             window_ms, ctx=telemetry.current_context(),
                             tenant=tenant)
            shadowed = True
        latency_s = time.monotonic() - t0
        if telemetry.active() is not None:
            telemetry.observe(telemetry.M_SERVING_REQUEST_S, latency_s)
            telemetry.observe(telemetry.serving_request_metric(model),
                              latency_s)
        if single:
            out = out[0]
        return PredictResult(out, model, active.version, latency_s,
                             shadowed)

    # -- the cluster serving plane -------------------------------------------

    @staticmethod
    def _cluster() -> Optional[Any]:
        """The cluster serving router iff the knobs arm it. Read through
        ``sys.modules``, so a process that never configured the engine,
        or left ``cluster_workers = 0`` or ``serving_cluster`` off, keeps
        the single-process request path and NEVER imports
        ``serving/cluster.py``."""
        eng = sys.modules.get("sparkdl_tpu_torch.engine.dataframe")
        if eng is None:
            return None
        cfg = eng.EngineConfig
        if not (cfg.serving_cluster and cfg.cluster_workers):
            return None
        from sparkdl_tpu_torch.serving import cluster as serving_cluster

        return serving_cluster.maybe_cluster_serving()

    def _predict_cluster(self, cluster: Any, model: str, rows: Any, *,
                         deadline_ms: Optional[float], priority: str,
                         tenant: Optional[str], t0: float
                         ) -> PredictResult:
        """A predict routed to a replica: version resolution, routing,
        failover and the cutover gate live in ``serving/cluster.py``;
        SLO-aware admission and the in-flight gauge stay here. Shadow
        mirroring is single-process only (in cluster mode a candidate
        replicates dark and cuts over cluster-atomically instead). The
        latency observation carries the request's span context as an
        exemplar, so a moved request's trace lands among the tail
        exemplars."""
        active = self.registry.deployment(model)
        self._admit(active, tenant=tenant)
        ctx = telemetry.current_context()
        self._note_inflight(1)
        try:
            out, version = cluster.predict(
                model, self.registry, rows, deadline_ms=deadline_ms,
                priority=priority, tenant=tenant, ctx=ctx)
        finally:
            self._note_inflight(-1)
        latency_s = time.monotonic() - t0
        if telemetry.active() is not None:
            telemetry.observe(telemetry.M_SERVING_REQUEST_S, latency_s,
                              exemplar=ctx)
            telemetry.observe(telemetry.serving_request_metric(model),
                              latency_s, exemplar=ctx)
        return PredictResult(out, model, version, latency_s, False)

    def cutover(self, model: str, version: str) -> str:
        """Hot-swap ``model`` to ``version``; returns the previous
        active version. Single-process: the registry's atomic pointer
        flip. Cluster mode: the two-phase cluster-atomic cutover (every
        replica loads and acks the new version, then ONE flip), and a
        failed prepare rolls back with the old version still serving
        everywhere."""
        cluster = self._cluster()
        if cluster is not None:
            return cluster.cutover(model, self.registry, version)
        return self.registry.cutover(model, version)

    def rollback(self, model: str) -> str:
        """Cut back to the previous active version — the same primitive
        as :meth:`cutover`, aimed backwards, cluster-atomic when the
        cluster serving plane is armed."""
        cluster = self._cluster()
        if cluster is not None:
            return cluster.rollback(model, self.registry)
        return self.registry.rollback(model)

    # -- SLO-aware admission -------------------------------------------------

    def _admit(self, dep: Any, tenant: Optional[str] = None) -> None:
        target_s = dep.latency_target_s
        if target_s is None or self._admission != "shed":
            return  # block mode: executor backpressure + deadline bound it
        tel = telemetry.active()
        if tel is None:
            return  # no live metric plane, nothing to decide on
        snap = tel.metrics.window_snapshot(self._slo_window_s)
        hist = snap["histograms"].get(telemetry.M_QUEUE_WAIT_S)
        p99 = hist.get("p99") if hist else None
        budget_s = target_s * self._queue_wait_budget_frac
        if p99 is not None and p99 > budget_s:
            health.record(health.SERVING_SHED, model=dep.name,
                          version=dep.version, queue_wait_p99_s=p99,
                          budget_s=budget_s,
                          tenant=tenant or executor.current_tenant()
                          or executor.DEFAULT_TENANT)
            raise ServingOverloaded(
                f"model {dep.name!r}: windowed queue-wait p99 "
                f"{p99:.4f}s exceeds the {budget_s:.4f}s queue budget "
                f"of its {target_s:.3f}s latency target")

    # -- shadow traffic ------------------------------------------------------

    def _run_shadow(self, name: str, active: Any, shadow: Any,
                    batch: Any, active_out: Any, active_s: float,
                    window_ms: Optional[float],
                    ctx: Optional[telemetry.SpanContext] = None,
                    tenant: Optional[str] = None) -> None:
        """Mirror ONE request to the shadow version: run it on the BULK
        lane (a candidate must never crowd live traffic), compare
        outputs element-wise, record divergence + both latencies. A
        shadow failure records ``serving_shadow_error`` and is
        swallowed — the client already has its answer from the active
        version. The shadow leg runs under its own
        ``sparkdl.serving_shadow`` span parented on the request context
        ``ctx``, and carries the request's ``tenant`` tag so
        candidate-version work burns the requesting tenant's
        fair-queueing quota, not another tenant's."""
        t0 = time.monotonic()
        try:
            with telemetry.span(telemetry.SPAN_SERVING_SHADOW,
                                parent=ctx, model=name,
                                shadow_version=shadow.version):
                shadow_out = executor.execute(
                    shadow.model(), batch, batch_size=shadow.batch_size,
                    priority=executor.PRIORITY_BULK,
                    coalesce_window_ms=window_ms, tenant=tenant)
        except Exception as e:  # noqa: BLE001 - recorded, never re-raised
            health.record(health.SERVING_SHADOW_ERROR, model=name,
                          active_version=active.version,
                          shadow_version=shadow.version,
                          error=type(e).__name__)
            return
        shadow_s = time.monotonic() - t0
        divergence = _max_divergence(active_out, shadow_out)
        if telemetry.active() is not None:
            telemetry.observe(telemetry.M_SERVING_SHADOW_DIVERGENCE,
                              divergence)
        health.record(health.SERVING_SHADOW_COMPARED, model=name,
                      active_version=active.version,
                      shadow_version=shadow.version,
                      divergence=divergence, active_s=active_s,
                      shadow_s=shadow_s)

    # -- plumbing ------------------------------------------------------------

    def _note_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            depth = self._inflight
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_SERVING_QUEUE_DEPTH, depth)

    def status(self) -> Dict[str, Any]:
        out = self._local_status()
        # the replica map of each deployment (worker -> versions deployed
        # and resident, resident bytes, depth in flight), read through
        # sys.modules: a status read never imports the cluster plane nor
        # spawns or replaces a router
        mod = sys.modules.get("sparkdl_tpu_torch.serving.cluster")
        cluster = mod.exporter_status() if mod is not None else None
        if cluster is not None:
            out["cluster"] = cluster
        return out

    def _local_status(self) -> Dict[str, Any]:
        with self._lock:
            inflight = self._inflight
        return {"inflight": inflight, "admission": self._admission,
                "models": self.registry.names()}


def _leaves(tree: Any) -> list:
    """The array leaves of an output: an array, or a tuple, list or dict
    of them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _max_divergence(a: Any, b: Any) -> float:
    """max |active - shadow| across every output leaf (0.0 for
    bit-identical outputs; a shape mismatch reports +inf — versions with
    different output schemas ARE divergent, not an error)."""
    a_leaves = _leaves(a)
    b_leaves = _leaves(b)
    if len(a_leaves) != len(b_leaves):
        return float("inf")
    worst = 0.0
    for x, y in zip(a_leaves, b_leaves):
        x = np.asarray(x)
        y = np.asarray(y)
        if x.shape != y.shape:
            return float("inf")
        if x.size:
            worst = max(worst, float(
                np.max(np.abs(x.astype(np.float64)
                              - y.astype(np.float64)))))
    return worst


#: every live ModelServer, for the snapshot exporter's ``serving`` key
_servers: "weakref.WeakSet[ModelServer]" = weakref.WeakSet()


def exporter_status() -> Optional[Dict[str, Any]]:
    """The live servers' in-flight depth and models (None when there is
    none): the ``serving`` key of the telemetry exporter's snapshots. It
    never reaches for the cluster router (which a read could spawn); the
    exporter reads the replica map from ``serving/cluster.py`` itself."""
    servers = list(_servers)
    if not servers:
        return None
    return {"servers": [srv._local_status() for srv in servers]}
