"""Versioned model deployments: deploy beside, shadow, cut over.

A port of ``sparkdl_tpu.serving.registry``, the serving plane's source of
truth for WHICH model a request runs:

- ``deploy(name, version, ...)`` registers a version next to the ones
  already serving — the first version of a name activates itself,
  later ones deploy dark until cut over.
- ``shadow(name, version, fraction)`` mirrors a deterministic fraction
  of traffic to a candidate version. Responses ALWAYS come from the
  active version; the shadow leg's outputs and latency are compared and
  recorded (``sparkdl.serving.shadow_divergence`` and the
  ``serving_shadow_compared`` health event) by the ModelServer.
- ``cutover(name, version)`` atomically flips the active pointer.
  Requests resolve their version at admission under the registry lock,
  so every in-flight request completes on the version it resolved —
  zero dropped, zero double-served. ``rollback(name)`` is the SAME
  primitive aimed at the previous active version.

A request holds a direct reference to its resolved
:class:`~sparkdl_tpu_torch.core.model_function.ModelFunction`, and every
device entry stays behind ``executor.execute``: the swap moves a
pointer, never a queue.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.core import health, telemetry
from sparkdl_tpu_torch.serving.residency import place


def _serving_warmup_armed() -> bool:
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    return bool(EngineConfig.serving_warmup)


def _serving_cluster_armed() -> bool:
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    return bool(EngineConfig.serving_cluster)


def warmup_deployment(model: Any, name: str, version: str,
                      batch_size: int) -> None:
    """Capture ``model``'s whole bucket ladder before the deployment
    takes traffic: one dummy batch per rung through the
    ``executor.execute`` choke point (``coalesce=False``), so each rung's
    exact program (precision variant, planner bucket) captures its CUDA
    graph and settles its kernel-gate auditions now.

    The rungs are those of the planner ``execute`` consults for this
    model (its name and ``batch_size``), as they stand now: under
    ``EngineConfig.bucket_ladder = "tuned"`` a rung the planner adopts
    later captures at its first request, so "the first request captures
    nothing" holds for every rung only under ``"pow2"``, whose ladder is
    fixed. The batch is staged in the
    spec's dtype, and for an image element (height, width, channels)
    also as uint8: staging passes uint8 through uncast (the device
    casts), so a request arrives in one of these two dtypes, and a graph
    is captured per dtype.

    Runs inside the deployment's loader, so under the residency
    single-flight at EVERY cold load: first deploy and reload after
    eviction. No-op unless ``EngineConfig.serving_warmup``; a model
    without a static input spec is skipped (its shapes are not known
    before the first request)."""
    if not _serving_warmup_armed():
        return
    from sparkdl_tpu_torch.core import batching, executor

    spec = getattr(model, "input_spec", None)
    shape = getattr(spec, "shape", None)
    if shape is None or any(d is None for d in shape[1:]):
        return
    elem = tuple(int(d) for d in shape[1:])
    dtypes = [np.dtype(spec.dtype)]
    if len(elem) == 3 and np.dtype(np.uint8) not in dtypes:
        dtypes.append(np.dtype(np.uint8))
    planner = batching.default_planner(getattr(model, "name", name),
                                       int(batch_size))
    rungs = (planner.ladder() if planner is not None
             else batching._pow2_ladder(int(batch_size), 8))
    t0 = time.monotonic()
    with telemetry.span(telemetry.SPAN_SERVING_WARMUP, model=name,
                        version=version, rungs=repr(tuple(rungs))):
        for dtype in dtypes:
            for rung in rungs:
                batch = np.zeros((int(rung),) + elem, dtype=dtype)
                executor.execute(model, batch, batch_size=int(batch_size),
                                 coalesce=False, tenant=None)
    health.record(health.WARMUP_COMPLETED, model=name, version=version,
                  rungs=len(rungs), seconds=time.monotonic() - t0)


class Deployment:
    """One (name, version) record: how to obtain the model, and the
    per-model serving knobs the ModelServer reads at admission.

    ``loader`` is a zero-arg callable returning the ModelFunction; a
    concrete model deploys as a pre-loaded entry. Materialization goes
    through the residency manager when one is attached to the registry
    (budget/eviction/pinning apply), else it is memoized here — either
    way the FIRST load after registration or eviction runs under a
    ``sparkdl.model_load`` span and places the weights on the configured
    device.
    """

    def __init__(self, name: str, version: str,
                 loader: Callable[[], Any],
                 latency_target_ms: Optional[float],
                 batch_size: int,
                 residency: Optional[Any]) -> None:
        self.name = name
        self.version = version
        self.loader = loader
        self.latency_target_ms = latency_target_ms
        self.batch_size = int(batch_size)
        self._residency = residency
        self._load_lock = threading.Lock()
        self._model: Optional[Any] = None

    @property
    def latency_target_s(self) -> Optional[float]:
        if self.latency_target_ms is None:
            return None
        return self.latency_target_ms / 1e3

    def resident_bytes(self) -> int:
        """Bytes of this version's weights if currently materialized,
        else 0 — never triggers a load."""
        if self._residency is not None:
            return self._residency.resident_bytes_for(self.name,
                                                      self.version)
        model = self._model
        if model is None:
            return 0
        return (int(model.weight_bytes())
                if hasattr(model, "weight_bytes") else 0)

    def model(self) -> Any:
        """The materialized ModelFunction (loading it on first use)."""
        if self._residency is not None:
            return self._residency.acquire(self.name, self.version)
        cached = self._model
        if cached is not None:
            return cached
        with self._load_lock:
            if self._model is None:
                t0 = time.monotonic()
                with telemetry.span(telemetry.SPAN_MODEL_LOAD,
                                    model=self.name,
                                    version=self.version):
                    self._model = place(self.loader())
                health.record(health.SERVING_COLD_START, model=self.name,
                              version=self.version,
                              seconds=time.monotonic() - t0)
            return self._model

    def __repr__(self) -> str:
        return f"Deployment({self.name!r}, version={self.version!r})"


class _Entry:
    """Per-model-name registry slot; every field is guarded by the
    owning registry's lock."""

    def __init__(self) -> None:
        self.versions: Dict[str, Deployment] = {}
        self.active: Optional[str] = None
        self.previous: Optional[str] = None  # rollback target
        self.shadow_version: Optional[str] = None
        self.shadow_fraction = 0.0
        self.shadow_acc = 0.0  # deterministic fraction accumulator


class ModelRegistry:
    """Thread-safe versioned deployments (one instance per serving
    plane; :func:`default_registry` is the process-wide one the ml/udf
    layers resolve string model names through)."""

    def __init__(self, residency: Optional[Any] = None, *,
                 defer_warmup: bool = False) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._residency = residency
        # Cluster replicas set this: their boot config clears
        # serving_cluster (a worker is not a coordinator), so without it
        # the deploy fan-out would materialize EVERY version on EVERY
        # replica. A replica warms at its own cold load (its first routed
        # predict or its srv_prepare), where a broken loader nacks the
        # prepare instead of killing the worker.
        self._defer_warmup = bool(defer_warmup)

    # -- deployment lifecycle ------------------------------------------------

    def deploy(self, name: str, version: str, model: Any = None, *,
               loader: Optional[Callable[[], Any]] = None,
               latency_target_ms: Optional[float] = None,
               batch_size: int = 64,
               activate: Optional[bool] = None) -> Deployment:
        """Register ``version`` of ``name``. Exactly one of ``model`` /
        ``loader`` must be given. The first version of a name activates
        itself; later versions deploy dark unless ``activate=True``
        (which is a :meth:`cutover`). Deploy-time side effects: the
        per-model latency metric is declared, and the version is
        registered with the residency manager (pinned iff active)."""
        if (model is None) == (loader is None):
            raise ValueError("deploy() takes exactly one of model=/loader=")
        if loader is None:
            def loader(m=model):
                return m
        # Every materialization path — Deployment.model() and the
        # residency manager's single-flight acquire, post-eviction
        # reloads included — funnels through the loader, so wrapping it
        # HERE makes the warm-up cover all of them (warmup_deployment
        # no-ops when the knob is off). The marker keeps the wrap one
        # layer deep when a wrapped loader is deployed again.
        raw_loader = loader

        if getattr(raw_loader, "_sparkdl_warmup_wrap", False):
            loader = raw_loader
        else:
            def loader(name=name, version=version,
                       batch_size=batch_size, _load=raw_loader):
                m = place(_load())
                warmup_deployment(m, name, version, batch_size)
                return m

            loader._sparkdl_warmup_wrap = True

        if latency_target_ms is not None and latency_target_ms <= 0:
            raise ValueError(
                f"latency_target_ms must be > 0 (or None), got "
                f"{latency_target_ms!r}")
        dep = Deployment(name, version, loader, latency_target_ms,
                         batch_size, self._residency)
        telemetry.declare_metric(telemetry.serving_request_metric(name),
                                 "histogram")
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
            if version in entry.versions:
                raise ValueError(
                    f"model {name!r} version {version!r} already "
                    "deployed — versions are immutable; deploy a new "
                    "version and cut over")
            entry.versions[version] = dep
            first = entry.active is None
            if first:
                entry.active = version
        if self._residency is not None:
            self._residency.register(name, version, loader, pinned=first)
        if activate and not first:
            self.cutover(name, version)
        # Eagerly materialize (and therefore warm) at deploy time so the
        # FIRST request captures nothing — except when the cluster plane
        # is armed, whose replicas load worker-side, and in a replica,
        # which loads at its own cold load.
        if _serving_warmup_armed() and not _serving_cluster_armed() \
                and not self._defer_warmup:
            dep.model()
        return dep

    def shadow(self, name: str, version: Optional[str],
               fraction: float = 1.0) -> None:
        """Mirror ``fraction`` of ``name``'s traffic to ``version``
        (``None`` clears shadowing). Deterministic: an accumulator takes
        every ceil(1/fraction)-th request, so tests and replay runs see
        the same shadow set — no RNG."""
        if version is not None and not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"shadow fraction must be in (0, 1], got {fraction!r}")
        with self._lock:
            entry = self._require_locked(name)
            if version is None:
                entry.shadow_version = None
                entry.shadow_fraction = 0.0
                entry.shadow_acc = 0.0
                return
            if version not in entry.versions:
                raise KeyError(
                    f"model {name!r} has no version {version!r} to "
                    f"shadow; deployed: {sorted(entry.versions)}")
            if version == entry.active:
                raise ValueError(
                    f"model {name!r} version {version!r} is the active "
                    "version — shadowing it onto itself is meaningless")
            entry.shadow_version = version
            entry.shadow_fraction = float(fraction)
            entry.shadow_acc = 0.0

    def cutover(self, name: str, version: str) -> str:
        """Atomically make ``version`` the active version of ``name``;
        returns the previous active version. In-flight requests finish
        on the version they resolved at admission (no request is
        dropped or served twice); the residency pin moves with the
        active pointer. A shadow pointing at the new active clears."""
        with self._lock:
            entry = self._require_locked(name)
            if version not in entry.versions:
                raise KeyError(
                    f"model {name!r} has no version {version!r}; "
                    f"deployed: {sorted(entry.versions)}")
            prev = entry.active
            if version == prev:
                return prev
            entry.previous = prev
            entry.active = version
            if entry.shadow_version == version:
                entry.shadow_version = None
                entry.shadow_fraction = 0.0
                entry.shadow_acc = 0.0
        if self._residency is not None:
            # pin BEFORE unpin: the new active must never be evictable,
            # even for the instant between the two calls
            self._residency.pin(name, version, pinned=True)
            if prev is not None:
                self._residency.pin(name, prev, pinned=False)
        health.record(health.SERVING_CUTOVER, model=name,
                      previous=prev, to=version)
        return prev

    def rollback(self, name: str) -> str:
        """Cut back over to the previous active version — the SAME
        atomic primitive as :meth:`cutover`, aimed backwards."""
        with self._lock:
            entry = self._require_locked(name)
            target = entry.previous
        if target is None:
            raise ValueError(
                f"model {name!r} has no previous active version to "
                "roll back to")
        return self.cutover(name, target)

    # -- request-path resolution ---------------------------------------------

    def resolve(self, name: str
                ) -> Tuple[Deployment, Optional[Deployment]]:
        """The admission-time snapshot for ONE request: ``(active,
        shadow)`` where ``shadow`` is the deployment to mirror THIS
        request to (``None`` for the complement of the shadow
        fraction). Atomic under the registry lock — a concurrent
        cutover happens entirely before or entirely after."""
        with self._lock:
            entry = self._require_locked(name)
            active = entry.versions[entry.active]
            shadow = None
            if entry.shadow_version is not None:
                entry.shadow_acc += entry.shadow_fraction
                if entry.shadow_acc >= 1.0 - 1e-9:
                    entry.shadow_acc -= 1.0
                    shadow = entry.versions[entry.shadow_version]
            return active, shadow

    def model(self, name: str) -> Any:
        """The ACTIVE version's materialized ModelFunction — the hook
        the ml/udf layers use to resolve a string ``modelFunction``
        param through the serving plane (hot-swap applies to batch
        transformers too: each transform call re-resolves)."""
        active, _ = self.resolve(name)
        return active.model()

    def deployment(self, name: str,
                   version: Optional[str] = None) -> Deployment:
        """The :class:`Deployment` record for (name, version) — the
        ACTIVE version when ``version`` is None — WITHOUT
        :meth:`resolve`'s shadow-accumulator side effect: admission checks
        must not consume shadow slots."""
        with self._lock:
            entry = self._require_locked(name)
            v = entry.active if version is None else version
            if v not in entry.versions:
                raise KeyError(
                    f"model {name!r} has no version {v!r}; deployed: "
                    f"{sorted(entry.versions)}")
            return entry.versions[v]

    def deployments(self, name: str) -> Dict[str, Deployment]:
        """Every deployed version of ``name`` (a snapshot copy)."""
        with self._lock:
            return dict(self._require_locked(name).versions)

    # -- introspection -------------------------------------------------------

    def active_version(self, name: str) -> str:
        with self._lock:
            return self._require_locked(name).active

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def targets(self) -> Dict[str, float]:
        """``{model name: active version's p99 target in seconds}`` for
        every model with a latency target — the input
        ``slo.default_serving_rules`` wants."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, entry in self._entries.items():
                dep = entry.versions.get(entry.active)
                if dep is not None and dep.latency_target_s is not None:
                    out[name] = dep.latency_target_s
        return out

    def status(self, name: str) -> Dict[str, Any]:
        with self._lock:
            entry = self._require_locked(name)
            return {
                "active": entry.active,
                "previous": entry.previous,
                "versions": sorted(entry.versions),
                "shadow_version": entry.shadow_version,
                "shadow_fraction": entry.shadow_fraction,
            }

    def _require_locked(self, name: str) -> _Entry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"no model named {name!r} deployed; deployed models: "
                f"{sorted(self._entries)}") from None


_default_registry = ModelRegistry()


def default_registry() -> ModelRegistry:
    """The process-wide registry (the ml/udf string-name resolution
    target). Serving stacks that want isolation construct their own."""
    return _default_registry
