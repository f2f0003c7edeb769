"""Cluster serving plane: replicated deployments, failover, atomic swap.

A port of ``sparkdl_tpu.serving.cluster``. ``EngineConfig.serving_cluster``
(with ``cluster_workers > 0``) lifts the serving plane from one process
onto the cluster workers of ``cluster/router.py``:

- **Replication.** Every deployed (model, version) fans out to every live
  cluster worker as a loader pickled by ``cluster/transport.py``
  (closures by value, weights as CPU arrays), sent ONCE per worker over
  the router's private task queues. Each worker holds a whole replica
  (:class:`WorkerServingPlane`: a ModelRegistry of its own and an optional
  ``serving_worker_residency_bytes`` budget) and runs it on its own card
  context through its own executor, captured graphs and kernels.
- **Routing.** :meth:`ClusterServingRouter.predict` routes by load and
  locality: workers that already hold the version resident win, the
  fewest requests in flight breaks ties, and a version resident nowhere
  goes to ONE designated warming worker (single-flight across the
  cluster: N callers never start N cold loads). Rows cross the pipe as a
  plain pickle of a numpy array, and answers as a plain pickle of the
  executor's numpy output.
- **Failover.** A worker's death surfaces (through the router's EOF reap)
  exactly the serving request ids that worker owed answers for; each is
  re-admitted on a surviving replica within the CALLER's remaining
  deadline. Predict is idempotent and journal-free, so the move is
  invisible to the caller beyond latency. Accounting is exactly-once:
  one ``serving_failover`` health event per moved request, recorded at
  the one re-admission site.
- **Cluster-atomic hot swap.** :meth:`ClusterServingRouter.cutover` is
  two-phase: *prepare* makes every live replica pin and load the new
  version and ack; *commit* closes the deployment's admission gate,
  drains the predicts in flight, flips ONE pointer, moves the pins and
  reopens. The last old-version answer strictly precedes the first
  new-version admission. Any failure of prepare rolls back (the new
  version unpinned wherever it loaded, ``serving_prepare_failed``
  recorded) with the old version still serving everywhere.

A replica answers one predict at a time: the worker's loop is its only
caller, and each routed predict waits out its own coalesce window alone.

Lock order is one way only: the serving lock may take the router lock
(``serving_send`` / ``serving_live_workers`` / ``serving_done``), never
the reverse; the router calls every handler callback (``on_message`` /
``on_worker_lost`` / ``on_worker_spawn`` / ``on_close``) with its own
lock released. Every wait here is bounded.

This module is imported only when the knobs arm it (``ModelServer.
_cluster`` reads them through ``sys.modules`` first); a process with
``cluster_workers = 0`` keeps the single-process serving path and never
loads this file.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import signal
import threading
import time
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from sparkdl_tpu_torch.cluster import transport
from sparkdl_tpu_torch.core import executor, health, resilience, telemetry
from sparkdl_tpu_torch.serving import server as _server
from sparkdl_tpu_torch.serving.registry import ModelRegistry
from sparkdl_tpu_torch.serving.residency import ResidencyManager

__all__ = ["ClusterServingRouter", "CutoverFailed", "WorkerServingPlane",
           "exporter_status", "maybe_cluster_serving", "reset"]

# Poll cadences: waiters re-check their deadline and the closed state
# between event waits (against lost wakeups, as the batch router does).
_WAIT_POLL_S = 0.05
_GATE_POLL_S = 0.05
# Default bound on a cutover's prepare acks and its commit drain: cold
# loads are slow, but a wedged replica must not hold the swap forever.
_CUTOVER_TIMEOUT_S = 60.0


class CutoverFailed(RuntimeError):
    """A cluster-atomic cutover aborted: prepare failed on some replica
    (or the commit drain timed out) and was rolled back; the previous
    version is still serving everywhere, nothing flipped."""


def _dumps(obj: Any) -> bytes:
    """Rows and answers on the pipe: a plain pickle of numpy arrays."""
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


# =============================================================================
# Worker side: one replica per cluster worker process
# =============================================================================

class WorkerServingPlane:
    """One cluster worker's serving replica: a ModelRegistry of its own
    (with a byte-budgeted ResidencyManager when
    ``EngineConfig.serving_worker_residency_bytes`` is set) fed by
    ``srv_*`` messages off the worker's task queue. Single-threaded by
    construction (the worker loop is its only caller), so it takes no
    lock; replies go back over the worker's private result pipe (one
    writer per pipe)."""

    def __init__(self, worker_id: int, name: str, conn: Any) -> None:
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        self.worker_id = worker_id
        self.name = name
        self._conn = conn
        budget = EngineConfig.serving_worker_residency_bytes
        self._residency: Optional[ResidencyManager] = (
            ResidencyManager(budget) if budget else None)
        # defer_warmup: a replica loads (and warms, with serving_warmup
        # armed) at ITS cold load, its first routed predict or its
        # srv_prepare, never at the deploy fan-out, which would load
        # every version on every replica and turn a broken loader into a
        # worker death instead of a prepare nack
        self._registry = ModelRegistry(residency=self._residency,
                                       defer_warmup=True)
        self._deployed: Dict[Tuple[str, str], Any] = {}
        self._predicts = 0
        self._errors = 0

    # -- message dispatch ----------------------------------------------------

    def handle(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "srv_deploy":
            self._deploy(*msg[1:])
        elif kind == "srv_retire":
            self._retire(*msg[1:])
        elif kind == "srv_pin":
            self._pin(*msg[1:])
        elif kind == "srv_prepare":
            self._prepare(*msg[1:])
        elif kind == "srv_predict":
            self._predict(*msg[1:])
        # an unknown srv_* kind is ignored: a worker must not die (and
        # take its answers in flight with it) over a message it does not
        # speak

    def _deploy(self, name: str, version: str, blob: bytes,
                batch_size: int, latency_target_ms: Optional[float],
                pinned: bool) -> None:
        """Idempotent: a replica top-up fans every deployment out to a
        fresh worker again, and a retire/redeploy cycle reuses the
        immutable registry record."""
        key = (name, version)
        if key not in self._deployed:
            loader = transport.loads(blob)
            try:
                dep = self._registry.deploy(
                    name, version, loader=loader,
                    latency_target_ms=latency_target_ms,
                    batch_size=batch_size)
            except ValueError:
                # redeployed after a retire: versions are immutable
                dep = self._registry.deployment(name, version)
            self._deployed[key] = dep
        if self._residency is not None:
            self._residency.pin(name, version, pinned=bool(pinned))

    def _retire(self, name: str, version: str) -> None:
        if self._deployed.pop((name, version), None) is None:
            return
        if self._residency is not None:
            self._residency.pin(name, version, pinned=False)
            self._residency.evict(name, version)

    def _pin(self, name: str, version: str, pinned: bool) -> None:
        if (self._residency is not None
                and (name, version) in self._deployed):
            self._residency.pin(name, version, pinned=bool(pinned))

    def _prepare(self, req_id: int, name: str, version: str) -> None:
        """Phase one of a cluster-atomic cutover, on the replica: pin the
        incoming version FIRST (it must not be evicted before the
        commit), then load it (and warm it) and ack."""
        try:
            dep = self._require(name, version)
            if self._residency is not None:
                self._residency.pin(name, version, pinned=True)
            dep.model()  # the cold load, warm-up included
        except Exception as e:  # noqa: BLE001 - nacked to the coordinator
            self._conn.send(("srv_prepared", req_id, False,
                             f"{type(e).__name__}: {e}",
                             self._resident_bytes()))
            return
        self._conn.send(("srv_prepared", req_id, True, None,
                         self._resident_bytes()))

    def _predict(self, req_id: int, name: str, version: str,
                 payload: bytes, deadline_ms: Optional[float],
                 priority: str, tenant: Optional[str], ctx: Any,
                 crash: bool) -> None:
        """One routed request: staged as the single-process ModelServer
        stages it (the same helpers), run through THIS worker's executor,
        answered over the pipe. ``crash`` is the armed
        ``serving_worker_kill`` marker: die as hard as a lost machine,
        with no cleanup; the coordinator's failover takes it from
        there."""
        if crash:
            os.kill(os.getpid(), signal.SIGKILL)
        t0 = time.perf_counter()
        try:
            dep = self._require(name, version)
            rows = pickle.loads(payload)
            batch, single = _server.stage_rows(dep, rows)
            deadline = (resilience.Deadline(deadline_ms / 1e3)
                        if deadline_ms is not None else None)
            with telemetry.span(telemetry.SPAN_SERVING_PREDICT,
                                parent=ctx, model=name, version=version,
                                cluster_worker=self.worker_id):
                out = executor.execute(
                    dep.model(), batch, batch_size=dep.batch_size,
                    priority=priority, deadline=deadline,
                    coalesce_window_ms=_server.target_window_ms(dep),
                    tenant=tenant)
            if single:
                out = out[0]
            blob = _dumps(out)
        except Exception as e:  # noqa: BLE001 - re-raised by the caller
            self._errors += 1
            self._conn.send(("srv_err", req_id, type(e).__name__,
                             str(e), resilience.classify(e)))
            return
        self._predicts += 1
        self._conn.send(("srv_ok", req_id, blob,
                         {"exec_s": time.perf_counter() - t0,
                          "resident_bytes": self._resident_bytes()}))

    # -- plumbing ------------------------------------------------------------

    def _require(self, name: str, version: str) -> Any:
        dep = self._deployed.get((name, version))
        if dep is None:
            raise KeyError(
                f"worker {self.name} holds no deployment {name!r} "
                f"v{version!r}: the deploy fan-out never arrived")
        return dep

    def _resident_bytes(self) -> int:
        if self._residency is not None:
            return self._residency.resident_bytes()
        return sum(dep.resident_bytes()
                   for dep in self._deployed.values())

    def stats(self) -> Dict[str, Any]:
        """This replica's end-of-run section, shipped inside the final
        snapshot (``cluster/aggregate.py`` folds them cluster-wide)."""
        deployments = []
        for (name, version), dep in sorted(self._deployed.items()):
            if self._residency is not None:
                resident = self._residency.is_resident(name, version)
            else:
                resident = dep._model is not None  # unbudgeted: memoized
            deployments.append({"model": name, "version": version,
                                "resident": resident,
                                "bytes": dep.resident_bytes()})
        return {"worker": self.name,
                "predicts": self._predicts,
                "errors": self._errors,
                "resident_bytes": self._resident_bytes(),
                "deployments": deployments}


# =============================================================================
# Coordinator side: the replicated-serving router
# =============================================================================

class _VersionRoute:
    """The coordinator's view of one replicated (model, version); every
    field is guarded by the owning ClusterServingRouter's lock."""

    __slots__ = ("blob", "batch_size", "latency_target_ms", "deployed",
                 "resident", "warming")

    def __init__(self, blob: bytes, batch_size: int,
                 latency_target_ms: Optional[float]) -> None:
        self.blob = blob
        self.batch_size = batch_size
        self.latency_target_ms = latency_target_ms
        self.deployed: Set[int] = set()   # wids holding the loader
        self.resident: Set[int] = set()   # wids that answered hot
        self.warming: Optional[int] = None  # the single-flight cold target


class _DeploymentRoute:
    """Routing state of one model. ``gate`` is the admission gate a
    cluster-atomic cutover closes for its commit window; ``swap_lock``
    serializes the cutovers of one deployment."""

    __slots__ = ("name", "active", "previous", "versions", "gate",
                 "inflight", "swap_lock")

    def __init__(self, name: str, active: str) -> None:
        self.name = name
        self.active = active
        self.previous: Optional[str] = None
        self.versions: Dict[str, _VersionRoute] = {}
        self.gate = threading.Event()
        self.gate.set()
        self.inflight = 0
        self.swap_lock = threading.Lock()


class _Call:
    """One serving exchange in flight (a predict or a prepare). Its
    fields are written under the serving lock; the waiter reads them
    only after ``event`` is set."""

    __slots__ = ("req_id", "kind", "name", "version", "payload",
                 "deadline", "deadline_ms_total", "priority", "tenant",
                 "ctx", "event", "blob", "meta", "result", "error",
                 "worker", "failovers", "started")

    def __init__(self, kind: str, name: str) -> None:
        self.started = time.monotonic()
        self.req_id = 0
        self.kind = kind
        self.name = name
        self.version: Optional[str] = None
        self.payload: Optional[bytes] = None
        self.deadline: Optional[float] = None  # absolute, monotonic
        self.deadline_ms_total: Optional[float] = None
        self.priority = executor.PRIORITY_INTERACTIVE
        self.tenant: Optional[str] = None
        self.ctx: Any = None
        self.event = threading.Event()
        self.blob: Optional[bytes] = None
        self.meta: Dict[str, Any] = {}
        self.result: Optional[Tuple] = None  # prepare: (ok, err, bytes)
        self.error: Optional[BaseException] = None
        self.worker: Optional[int] = None
        self.failovers = 0

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, (self.deadline - time.monotonic()) * 1e3)


class ClusterServingRouter:
    """Routes ``ModelServer.predict`` across the cluster's replicas and
    owns failover re-admission and the two-phase cutover. One per
    :class:`~sparkdl_tpu_torch.cluster.router.ClusterRouter` (it attaches
    itself as the router's serving handler)."""

    def __init__(self, router: Any) -> None:
        self.router = router
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._routes: Dict[str, _DeploymentRoute] = {}
        self._pending: Dict[int, _Call] = {}
        self._ids = itertools.count(1)
        self._wid_inflight: Dict[int, int] = {}
        self._worker_bytes: Dict[int, int] = {}
        self._predicts = 0
        self._failovers = 0
        self._moved: List[int] = []
        # a moved request's id -> seconds from its admission to its
        # answer (or its classified failure)
        self._moved_s: Dict[int, float] = {}
        self._cutovers = 0
        self._prepare_failures = 0
        self._closed = False
        router.serving_attach(self)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- deployment fan-out --------------------------------------------------

    def _ensure(self, name: str, registry: Any,
                adopt: bool = True) -> None:
        """Bring the coordinator's registry into the replica plane:
        versions the routes have not seen fan out to every live worker
        (sent once), and, with ``adopt``, an active pointer of the
        registry that the router has not adopted (someone called
        ``registry.cutover`` directly) converges through the
        cluster-atomic two-phase swap."""
        deps = registry.deployments(name)
        reg_active = registry.active_version(name)
        with self._lock:
            route = self._routes.get(name)
            missing = [v for v in sorted(deps)
                       if route is None or v not in route.versions]
        blobs: Dict[str, bytes] = {}
        for v in missing:
            # pickled OUTSIDE the lock: a loader may hold real weights
            blobs[v] = transport.dumps(deps[v].loader)
        with self._lock:
            route = self._routes.get(name)
            if route is None:
                route = _DeploymentRoute(name, reg_active)
                self._routes[name] = route
            live: Optional[List[int]] = None
            for v in missing:
                if v in route.versions:
                    continue  # a concurrent _ensure got there first
                dep = deps[v]
                vr = _VersionRoute(blobs[v], dep.batch_size,
                                   dep.latency_target_ms)
                route.versions[v] = vr
                if live is None:
                    live = self.router.serving_live_workers()
                self._fan_deploy_locked(name, route, v, vr, live)
            mismatch = (adopt and route.active != reg_active
                        and reg_active in route.versions)
        if mismatch:
            self._adopt(name, registry, route)

    def _adopt(self, name: str, registry: Any, route: _DeploymentRoute,
               timeout_s: float = _CUTOVER_TIMEOUT_S) -> None:
        """Converge on the registry's active pointer through the two-phase
        swap. The pointers are read again under the swap lock: a
        :meth:`cutover` flips the route and then the registry, both under
        that lock, so a reader that caught it between the two flips waits
        here and then finds them agreeing, instead of undoing it."""
        with self._swap_held(name, route, timeout_s):
            target = registry.active_version(name)
            with self._lock:
                if (route.active == target
                        or target not in route.versions):
                    return
            self._swap(name, route, target, timeout_s)

    def _fan_deploy_locked(self, name: str, route: _DeploymentRoute,
                           version: str, vr: _VersionRoute,
                           wids: Sequence[int]) -> None:
        """Send one version's loader to ``wids``. Under the serving lock,
        so a version never becomes routable on a worker before its deploy
        message is queued there (the queue is FIFO: the deploy strictly
        precedes any predict routed there)."""
        for wid in wids:
            if wid in vr.deployed:
                continue
            try:
                self.router.serving_send(
                    wid, ("srv_deploy", name, version, vr.blob,
                          vr.batch_size, vr.latency_target_ms,
                          version == route.active))
            except (resilience.ServingReplicaLost,
                    resilience.WorkerDraining):
                continue  # leaving anyway; the EOF reap drops it
            vr.deployed.add(wid)

    def on_worker_spawn(self, wid: int) -> None:
        """Router callback (after a spawn, router lock released): top the
        new worker up with every deployment and the active pins, which
        restores the replication factor."""
        with self._lock:
            if self._closed:
                return
            for name, route in sorted(self._routes.items()):
                for version, vr in sorted(route.versions.items()):
                    self._fan_deploy_locked(name, route, version, vr,
                                            (wid,))

    def retire(self, name: str, version: str) -> None:
        """Retire one version that is not active, cluster-wide (evicted
        and unpinned on every replica; the route forgets it)."""
        with self._lock:
            route = self._routes.get(name)
            if route is None or version not in route.versions:
                return
            if version == route.active:
                raise ValueError(
                    f"model {name!r} v{version!r} is the active "
                    "version; cut over before retiring it")
            vr = route.versions.pop(version)
            for wid in sorted(vr.deployed):
                try:
                    self.router.serving_send(
                        wid, ("srv_retire", name, version))
                except (resilience.ServingReplicaLost,
                        resilience.WorkerDraining):
                    continue

    # -- the request path ----------------------------------------------------

    def predict(self, name: str, registry: Any, rows: Any, *,
                deadline_ms: Optional[float] = None,
                priority: str = executor.PRIORITY_INTERACTIVE,
                tenant: Optional[str] = None,
                ctx: Any = None) -> Tuple[Any, str]:
        """Route one request to a replica and await its answer; returns
        ``(output, version)``. The version resolves ONCE at admission
        (under the serving lock, behind any cutover's gate) and a
        failover keeps it: a moved request never switches versions."""
        self._ensure(name, registry)
        call = self._call(name, _dumps(np.asarray(rows)), deadline_ms)
        call.priority = priority
        call.tenant = tenant
        call.ctx = ctx
        self._admit(call)
        return pickle.loads(self._await(call)), call.version

    def predict_each(self, name: str, registry: Any, rows: Any, *,
                     deadline_ms: float) -> Dict[str, Tuple[Any, str]]:
        """One predict of the active version on EVERY live replica that
        holds it: ``{worker name: (output, version)}``, keyed by the
        worker that answered. Each goes through :meth:`predict`'s
        admission with its replica pinned instead of picked (a probe that
        each replica answers, after a failed cutover, say)."""
        self._ensure(name, registry)
        payload = _dumps(np.asarray(rows))
        with self._lock:
            vr = self._routes[name].versions[self._routes[name].active]
            wids = [wid for wid in self.router.serving_live_workers()
                    if wid in vr.deployed]
        calls = []
        for wid in wids:
            call = self._call(name, payload, deadline_ms)
            self._admit(call, replica=wid)
            calls.append(call)
        return {self.router.serving_worker_name(call.worker):
                (pickle.loads(self._await(call)), call.version)
                for call in calls}

    @staticmethod
    def _call(name: str, payload: bytes,
              deadline_ms: Optional[float]) -> _Call:
        call = _Call("predict", name)
        call.payload = payload
        call.deadline_ms_total = deadline_ms
        if deadline_ms is not None:
            call.deadline = time.monotonic() + deadline_ms / 1e3
        return call

    def _admit(self, call: _Call, replica: Optional[int] = None) -> None:
        """Admit one predict behind the deployment's gate and dispatch it
        to the replica routing picks (or to ``replica``)."""
        with self._lock:
            route = self._routes[call.name]
        while True:
            # the admission gate: a cluster-atomic cutover closes the
            # deployment for its commit window; a new predict waits for
            # the flip (bounded by its own deadline), never races it
            if not route.gate.wait(timeout=_GATE_POLL_S):
                self._check_admission(call)
                continue
            with self._lock:
                if self._closed:
                    raise resilience.ServingReplicaLost(
                        "the cluster serving plane is closed")
                if not route.gate.is_set():
                    continue  # closed again between the wait and the lock
                version = route.active
                wid = self._pick_locked(route, version, replica)
                if wid is None:
                    raise resilience.ServingReplicaLost(
                        f"no live replica can serve {call.name!r} "
                        f"v{version!r}: every deployed worker is lost "
                        "or draining")
                call.version = version
                call.req_id = next(self._ids)
                self._pending[call.req_id] = call
                route.inflight += 1
                try:
                    self._dispatch_locked(call, wid)
                except (resilience.ServingReplicaLost,
                        resilience.WorkerDraining):
                    # died or began draining between pick and send
                    self._pending.pop(call.req_id, None)
                    route.inflight -= 1
                    continue
            return

    def _check_admission(self, call: _Call) -> None:
        if (call.deadline is not None
                and time.monotonic() >= call.deadline):
            raise resilience.DeadlineExceeded(
                f"predict on {call.name!r} spent its "
                f"{call.deadline_ms_total:.0f} ms deadline waiting on "
                "the cutover gate")
        if self._closed or self.router.closed:
            raise resilience.ServingReplicaLost(
                "cluster router closed while the request waited for "
                "admission")

    def _pick_locked(self, route: _DeploymentRoute, version: str,
                     replica: Optional[int] = None) -> Optional[int]:
        return self._pick_excluding_locked(route, version, (), replica)

    def _pick_excluding_locked(self, route: _DeploymentRoute,
                               version: str, exclude: Sequence[int],
                               replica: Optional[int] = None
                               ) -> Optional[int]:
        """The replica by locality and load: workers holding the version
        resident first, the fewest in flight breaking ties; a version
        resident nowhere goes through ONE designated warming worker (the
        cold load is single-flight cluster-wide). A pinned ``replica``
        is taken while it is live and holds the version."""
        vr = route.versions[version]
        live = [wid for wid in self.router.serving_live_workers()
                if wid in vr.deployed and wid not in exclude]
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_SERVING_REPLICAS, len(live))
        if replica is not None:
            return replica if replica in live else None
        if not live:
            return None
        resident = [wid for wid in live if wid in vr.resident]
        if resident:
            return min(resident, key=lambda w:
                       (self._wid_inflight.get(w, 0), w))
        if vr.warming in live:
            return vr.warming
        wid = min(live, key=lambda w: (self._wid_inflight.get(w, 0), w))
        vr.warming = wid
        return wid

    def _dispatch_locked(self, call: _Call, wid: int) -> None:
        crash = resilience.should_fire("serving_worker_kill",
                                       model=call.name,
                                       request=call.req_id)
        self.submit_predict(wid, call, crash=crash)
        call.worker = wid
        self._wid_inflight[wid] = self._wid_inflight.get(wid, 0) + 1

    def submit_predict(self, wid: int, call: _Call, *,
                       crash: bool = False) -> None:
        """The predict message on the wire. It carries the REMAINING
        deadline: a moved request is re-admitted with whatever budget
        its caller still has, not a fresh one."""
        self.router.serving_send(
            wid, ("srv_predict", call.req_id, call.name, call.version,
                  call.payload, call.remaining_ms(), call.priority,
                  call.tenant, call.ctx, crash),
            req_id=call.req_id)

    def _await(self, call: _Call) -> bytes:
        while not call.event.wait(_WAIT_POLL_S):
            if (call.deadline is not None
                    and time.monotonic() >= call.deadline):
                self._abandon(call)
                raise resilience.DeadlineExceeded(
                    f"predict {call.req_id} on {call.name!r} exceeded "
                    f"its {call.deadline_ms_total:.0f} ms deadline "
                    f"({call.failovers} failover(s))")
        if call.error is not None:
            raise call.error
        if call.blob is None:
            raise resilience.ServingReplicaLost(
                f"predict {call.req_id} on {call.name!r} resolved "
                "without an answer")
        return call.blob

    def _abandon(self, call: _Call) -> None:
        """A waiter past its deadline withdraws its pending entry, so a
        late answer (or a failover) cannot bring the request back."""
        with self._lock:
            if self._pending.pop(call.req_id, None) is None:
                return  # resolved meanwhile; the answer path won
            route = self._routes.get(call.name)
            if route is not None:
                route.inflight -= 1
                self._cond.notify_all()
            if call.worker is not None:
                self._discount_locked(call.worker)
        if call.worker is not None:
            self.router.serving_done(call.worker, call.req_id)

    def _discount_locked(self, wid: int) -> None:
        n = self._wid_inflight.get(wid, 0)
        if n > 1:
            self._wid_inflight[wid] = n - 1
        else:
            self._wid_inflight.pop(wid, None)

    # -- router callbacks (collector thread; router lock released) -----------

    def on_message(self, wid: int, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "srv_prepared":
            _, req_id, ok, err, nbytes = msg
            self.router.serving_done(wid, req_id)
            with self._lock:
                self._worker_bytes[wid] = int(nbytes)
                call = self._pending.pop(req_id, None)
                if call is None:
                    return
                call.result = (bool(ok), err, int(nbytes))
                if ok:
                    self._mark_resident_locked(call.name, call.version,
                                               wid)
                call.event.set()
            return
        if kind == "srv_ok":
            _, req_id, blob, meta = msg
            self._resolve(wid, req_id, blob=blob, meta=meta)
        elif kind == "srv_err":
            from sparkdl_tpu_torch.cluster.router import _rebuild_error

            _, req_id, type_name, message, err_kind = msg
            self._resolve(wid, req_id,
                          error=_rebuild_error(type_name, message,
                                               err_kind))

    def _resolve(self, wid: int, req_id: int, blob: Optional[bytes] = None,
                 meta: Optional[Dict] = None,
                 error: Optional[BaseException] = None) -> None:
        self.router.serving_done(wid, req_id)
        with self._lock:
            call = self._pending.pop(req_id, None)
            if call is None:
                return  # abandoned at its deadline; the late answer drops
            if error is None:
                call.blob = blob
                call.meta = dict(meta or {})
                self._worker_bytes[wid] = int(
                    call.meta.get("resident_bytes", 0))
                self._predicts += 1
                self._mark_resident_locked(call.name, call.version, wid)
            else:
                call.error = error
            self._finish_locked(call)

    def _mark_resident_locked(self, name: str, version: Optional[str],
                              wid: int) -> None:
        route = self._routes.get(name)
        if route is None or version not in route.versions:
            return
        vr = route.versions[version]
        vr.resident.add(wid)
        if vr.warming == wid:
            vr.warming = None

    def _finish_locked(self, call: _Call) -> None:
        if call.kind == "predict":
            route = self._routes.get(call.name)
            if route is not None:
                route.inflight -= 1
            if call.worker is not None:
                self._discount_locked(call.worker)
            if call.failovers:
                self._moved_s[call.req_id] = time.monotonic() - call.started
        call.event.set()
        self._cond.notify_all()

    def on_worker_lost(self, wid: int, req_ids: Sequence[int]) -> None:
        """A worker died owing answers for exactly ``req_ids``. Each
        predict in flight is re-admitted on a surviving replica within
        its caller's remaining deadline; a prepare in flight fails the
        cutover (its waiter rolls back). Exactly-once accounting: this is
        the ONLY site that records ``serving_failover``, one event per
        moved request."""
        moved: List[Tuple[_Call, Optional[int]]] = []
        with self._lock:
            self._wid_inflight.pop(wid, None)
            self._worker_bytes.pop(wid, None)
            for route in self._routes.values():
                for vr in route.versions.values():
                    vr.deployed.discard(wid)
                    vr.resident.discard(wid)
                    if vr.warming == wid:
                        vr.warming = None
            for req_id in req_ids:
                call = self._pending.get(req_id)
                if call is None:
                    continue
                if call.kind == "prepare":
                    call.result = (
                        False, f"worker {wid} died before acking the "
                        f"prepare of {call.name!r} v{call.version!r}", 0)
                    self._pending.pop(req_id, None)
                    self._finish_locked(call)
                    continue
                err = self._readmit_locked(call, wid)
                if err is None:
                    moved.append((call, call.worker))
                else:
                    call.error = err
                    self._pending.pop(req_id, None)
                    self._finish_locked(call)
        for call, to_wid in moved:
            health.record(health.SERVING_FAILOVER, model=call.name,
                          version=call.version, request=call.req_id,
                          from_worker=wid, to_worker=to_wid)
            if telemetry.active() is not None:
                telemetry.count(telemetry.M_SERVING_FAILOVER)

    def _readmit_locked(self, call: _Call,
                        dead_wid: int) -> Optional[BaseException]:
        """Dispatch one orphaned predict again; returns the error that
        fails it instead, or None when it moved."""
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        limit = max(0, int(EngineConfig.serving_failover_max))
        if call.failovers >= limit:
            return resilience.ServingReplicaLost(
                f"predict {call.req_id} on {call.name!r} "
                f"v{call.version!r} lost its worker "
                f"{call.failovers + 1} time(s); the failover budget "
                f"({limit}) is spent")
        if (call.deadline is not None
                and time.monotonic() >= call.deadline):
            return resilience.DeadlineExceeded(
                f"predict {call.req_id} on {call.name!r} lost worker "
                f"{dead_wid} with no deadline budget left to re-admit")
        route = self._routes.get(call.name)
        if route is None or call.version not in route.versions:
            return resilience.ServingReplicaLost(
                f"predict {call.req_id}: deployment {call.name!r} "
                f"v{call.version!r} is no longer routed")
        wid = self._pick_excluding_locked(route, call.version,
                                          (dead_wid,))
        if wid is None:
            return resilience.ServingReplicaLost(
                f"predict {call.req_id} on {call.name!r} "
                f"v{call.version!r}: worker {dead_wid} died and no "
                "surviving replica holds the version")
        try:
            self._dispatch_locked(call, wid)
        except (resilience.ServingReplicaLost,
                resilience.WorkerDraining) as e:
            return e
        call.failovers += 1
        self._failovers += 1
        self._moved.append(call.req_id)
        return None

    def on_close(self) -> None:
        """The router's close: fail every orphaned exchange (its waiter
        would otherwise poll until its deadline) and open every gate, so
        blocked admissions see the closed state."""
        with self._lock:
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
            for call in pending:
                if call.kind == "prepare":
                    call.result = (False, "cluster router closed "
                                   "mid-prepare", 0)
                else:
                    call.error = resilience.ServingReplicaLost(
                        "cluster router closed while the request was "
                        "in flight")
                self._finish_locked(call)
            for route in self._routes.values():
                route.gate.set()

    # -- cluster-atomic hot swap ---------------------------------------------

    def cutover(self, name: str, registry: Any, version: str, *,
                timeout_s: float = _CUTOVER_TIMEOUT_S) -> str:
        """Two-phase cluster-atomic hot swap; returns the previous active
        version.

        *Prepare*: every live replica pins and loads ``version`` and
        acks. A nack, a death or a timeout aborts: the new version is
        unpinned wherever it was prepared (``serving_prepare_failed``
        recorded) and :class:`CutoverFailed` raises, with the old version
        still serving everywhere.

        *Commit*: the deployment's admission gate closes, the predicts in
        flight drain, ONE pointer flips (then the coordinator registry's,
        which records ``serving_cutover`` and moves its pins), the
        workers' pins move and the gate reopens. The last old-version
        answer strictly precedes the first new-version admission: no two
        callers can observe mixed versions."""
        self._ensure(name, registry, adopt=False)
        with self._lock:
            route = self._routes.get(name)
            if route is None or version not in route.versions:
                raise KeyError(
                    f"model {name!r} has no version {version!r} to cut "
                    "over to")
        with self._swap_held(name, route, timeout_s):
            prev = self._swap(name, route, version, timeout_s)
            # the coordinator registry flips AFTER the cluster committed
            # (it records serving_cutover and moves its own pins), still
            # under the swap lock, so no adoption sees the two pointers
            # differ
            if prev != version and registry.active_version(name) != version:
                registry.cutover(name, version)
        return prev

    @contextlib.contextmanager
    def _swap_held(self, name: str, route: _DeploymentRoute,
                   timeout_s: float) -> Iterator[None]:
        """The deployment's swap lock, which serializes its cutovers."""
        if not route.swap_lock.acquire(timeout=2 * timeout_s):
            raise CutoverFailed(
                f"cluster cutover of {name!r}: another cutover held the "
                f"deployment for {2 * timeout_s:.0f}s")
        try:
            yield
        finally:
            route.swap_lock.release()

    def _swap(self, name: str, route: _DeploymentRoute, version: str,
              timeout_s: float) -> str:
        """Prepare and commit under the deployment's swap lock."""
        with self._lock:
            prev = route.active
            if prev == version:
                return prev
            vr = route.versions[version]
            targets = [wid for wid in self.router.serving_live_workers()
                       if wid in vr.deployed]
            if not targets:
                raise CutoverFailed(
                    f"no live replica holds {name!r} v{version!r} to "
                    "prepare")
            calls: List[_Call] = []
            for wid in targets:
                call = _Call("prepare", name)
                call.version = version
                call.req_id = next(self._ids)
                call.worker = wid
                self._pending[call.req_id] = call
                try:
                    self.router.serving_send(
                        wid, ("srv_prepare", call.req_id, name, version),
                        req_id=call.req_id)
                except (resilience.ServingReplicaLost,
                        resilience.WorkerDraining):
                    # leaving anyway: it serves neither version
                    self._pending.pop(call.req_id, None)
                    continue
                calls.append(call)
        failure: Optional[str] = None
        ack_deadline = time.monotonic() + timeout_s
        for call in calls:
            remaining = max(0.0, ack_deadline - time.monotonic())
            if not call.event.wait(remaining):
                with self._lock:
                    self._pending.pop(call.req_id, None)
                self.router.serving_done(call.worker, call.req_id)
                failure = (f"worker {call.worker} did not ack the "
                           f"prepare within {timeout_s:.0f}s")
                break
            ok, err, _ = call.result
            if not ok:
                failure = err
                break
        if failure is not None:
            self._rollback_prepare(name, version, targets)
            health.record(health.SERVING_PREPARE_FAILED, model=name,
                          version=version, error=failure)
            with self._lock:
                self._prepare_failures += 1
            raise CutoverFailed(
                f"cluster cutover of {name!r} to v{version!r} failed in "
                f"prepare; rolled back, v{prev!r} still serving "
                f"everywhere: {failure}")
        # COMMIT: close admission, drain, flip once, move the pins
        drain_deadline = time.monotonic() + timeout_s
        with self._lock:
            route.gate.clear()
            try:
                while route.inflight > 0:
                    # the swap lock is held by design (it serializes
                    # cutovers); the wakers take only the serving lock
                    if not self._cond.wait(timeout=_WAIT_POLL_S):
                        if time.monotonic() >= drain_deadline:
                            raise CutoverFailed(
                                f"cluster cutover of {name!r} to "
                                f"v{version!r}: {route.inflight} "
                                "predict(s) in flight did not drain "
                                f"within {timeout_s:.0f}s; aborted, "
                                f"v{prev!r} still active")
                route.previous = prev
                route.active = version
                for wid in sorted(vr.deployed):
                    try:
                        self.router.serving_send(
                            wid, ("srv_pin", name, prev, False))
                    except (resilience.ServingReplicaLost,
                            resilience.WorkerDraining):
                        continue
            finally:
                route.gate.set()
            self._cutovers += 1
        return prev

    def _rollback_prepare(self, name: str, version: str,
                          targets: Sequence[int]) -> None:
        """Undo a failed prepare: the new version is unpinned (evictable
        again) on every targeted worker; nothing flipped, so the old
        version's pins and the active pointer stay."""
        with self._lock:
            for wid in targets:
                try:
                    self.router.serving_send(
                        wid, ("srv_pin", name, version, False))
                except (resilience.ServingReplicaLost,
                        resilience.WorkerDraining):
                    continue

    def rollback(self, name: str, registry: Any) -> str:
        """Cut back to the previous active version, cluster-atomically
        (the same two-phase primitive aimed backwards)."""
        with self._lock:
            route = self._routes.get(name)
            target = route.previous if route is not None else None
        if target is None:
            raise ValueError(
                f"model {name!r} has no previous active version to "
                "roll back to")
        return self.cutover(name, registry, target)

    # -- introspection -------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The replica map of each deployment (worker name -> versions
        deployed and resident, last reported resident bytes, depth in
        flight), shown by ``ModelServer.status()["cluster"]`` and the
        exporter snapshot's ``serving`` section."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, route in sorted(self._routes.items()):
                wids: Set[int] = set()
                for vr in route.versions.values():
                    wids |= vr.deployed
                replicas = {}
                for wid in sorted(wids):
                    wname = self.router.serving_worker_name(wid)
                    replicas[wname] = {
                        "versions": sorted(
                            v for v, vr in route.versions.items()
                            if wid in vr.deployed),
                        "resident": sorted(
                            v for v, vr in route.versions.items()
                            if wid in vr.resident),
                        "resident_bytes": self._worker_bytes.get(wid, 0),
                        "inflight": self._wid_inflight.get(wid, 0),
                    }
                out[name] = {"active": route.active,
                             "inflight": route.inflight,
                             "replicas": replicas}
        return out

    def report_section(self) -> Dict[str, Any]:
        """The coordinator's ``serving.router`` block of the merged run
        report: routing totals, the exactly-once failover ledger (with
        each moved request's seconds from admission to its end) and the
        final replica topology."""
        with self._lock:
            return {
                "predicts": self._predicts,
                "failovers": self._failovers,
                "moved_requests": list(self._moved),
                "moved_latency_s": dict(self._moved_s),
                "cutovers": self._cutovers,
                "prepare_failures": self._prepare_failures,
                "deployments": {
                    name: {
                        "active": route.active,
                        "versions": {
                            v: {"deployed": sorted(vr.deployed),
                                "resident": sorted(vr.resident)}
                            for v, vr in sorted(route.versions.items())
                        },
                    }
                    for name, route in sorted(self._routes.items())},
            }


# =============================================================================
# Process-wide wiring
# =============================================================================

_mod_lock = threading.Lock()
_instance: Optional[ClusterServingRouter] = None


def maybe_cluster_serving() -> Optional[ClusterServingRouter]:
    """The process-wide serving router bound to the process-wide
    :func:`~sparkdl_tpu_torch.cluster.router.maybe_router` (built anew
    whenever that router was), or None when no cluster is armed. Callers
    (``ModelServer._cluster``) check the knobs BEFORE importing this
    module."""
    from sparkdl_tpu_torch.cluster import router as cluster_router

    router = cluster_router.maybe_router()
    if router is None:
        return None
    global _instance
    with _mod_lock:
        inst = _instance
        if inst is None or inst.router is not router or inst.closed:
            inst = ClusterServingRouter(router)
            _instance = inst
        return inst


def exporter_status() -> Optional[Dict[str, Any]]:
    """The live replica map for the snapshot exporter (None when no
    serving router is live: the exporter leaves the section out)."""
    inst = _instance
    if inst is None or inst.closed or inst.router.closed:
        return None
    return inst.status()


def reset() -> None:
    """Drop the process-wide instance (tests; the router's own shutdown
    already failed every exchange in flight)."""
    global _instance
    with _mod_lock:
        _instance = None
