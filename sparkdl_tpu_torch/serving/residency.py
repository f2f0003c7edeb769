"""Multi-model residency on the card: a byte budget, eviction, pinning.

A port of ``sparkdl_tpu.serving.residency``. The executor's idle-state
retirement (``EngineConfig.executor_idle_retire_s``) drops a model's
coalescing state when traffic stops; this module makes it a policy for
MANY models served at once:

- every registered (model, version) carries a zero-arg ``loader``; the
  weights materialize lazily on :meth:`ResidencyManager.acquire`, under
  a ``sparkdl.model_load`` span, and are placed on the configured device
  (``EngineConfig.device``) there, so a resident model's weights are on
  the card before its first request;
- resident bytes are accounted with
  :meth:`~sparkdl_tpu_torch.core.model_function.ModelFunction.weight_bytes`
  (the weights only: the CUDA graphs' memory pools are not counted);
  when a load would exceed the budget, unpinned victims are evicted —
  ``"lru"`` (default) the least recently used first, ``"weighted"`` by
  ``bytes x idle-age`` (biggest-coldest first);
- eviction drops the ledger's reference, retires the model's executor
  coalescing states (``DeviceExecutor.retire_model``) and drops every
  variant's captured graphs (``release_device_state``), so the weights,
  the graphs and their memory pools become collectible;
- PINNED versions (the registry pins every active version) are never
  victims; if the pinned set alone cannot fit beside a new load,
  :class:`ResidencyExhausted` is raised instead of thrashing.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.core import executor, health, telemetry

_POLICIES = ("lru", "weighted")


class ResidencyExhausted(RuntimeError):
    """The byte budget cannot hold this model beside the pinned set —
    raised instead of evicting a pinned (actively-deployed) version."""


class _Resident:
    """Ledger row for one (model, version); guarded by the manager's
    lock except ``loader`` (immutable)."""

    def __init__(self, name: str, version: str,
                 loader: Callable[[], Any], pinned: bool) -> None:
        self.name = name
        self.version = version
        self.loader = loader
        self.pinned = pinned
        self.model: Optional[Any] = None
        self.bytes = 0
        self.last_used = 0  # logical clock tick of the last acquire
        self.loading = False  # a thread is running the loader


def place(model: Any) -> Any:
    """``model`` with its weights on the configured device
    (``EngineConfig.device``; asking for the card without one raises):
    a model that is loaded is resident where it runs."""
    if hasattr(model, "to"):
        model.to(executor.resolve_device())
    return model


class ResidencyManager:
    """Thread-safe byte-budgeted model cache. One instance per serving
    plane, attached to the :class:`~sparkdl_tpu_torch.serving.registry.
    ModelRegistry` that routes materialization through it."""

    def __init__(self, budget_bytes: int, policy: str = "lru") -> None:
        if budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be > 0, got {budget_bytes!r}")
        if policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}, got {policy!r}")
        self._budget = int(budget_bytes)
        self._policy = policy
        # ONE Condition guards the whole ledger (its lock IS the
        # manager's lock; cold-load waiters park on it)
        self._cond = threading.Condition()
        self._residents: Dict[Tuple[str, str], _Resident] = {}
        self._clock = 0  # logical LRU clock (acquire order, not wall time)
        self._evictions = 0
        self._cold_starts = 0

    # -- registration / pinning ----------------------------------------------

    def register(self, name: str, version: str,
                 loader: Callable[[], Any], pinned: bool = False) -> None:
        """Add a (model, version) to the ledger — cheap; no load
        happens until :meth:`acquire`. Idempotent for the same key (the
        pin flag is NOT overwritten; use :meth:`pin`)."""
        key = (name, version)
        with self._cond:
            if key not in self._residents:
                self._residents[key] = _Resident(name, version, loader,
                                                 pinned)

    def pin(self, name: str, version: str, pinned: bool = True) -> None:
        """(Un)pin a version. Pinned versions are never eviction
        victims — the registry pins the active version of every model
        and moves the pin on cutover/rollback."""
        with self._cond:
            self._require_locked(name, version).pinned = bool(pinned)

    # -- the request path ----------------------------------------------------

    def acquire(self, name: str, version: str) -> Any:
        """The materialized ModelFunction for (name, version), loading
        it (cold start) and evicting victims to fit the budget when
        needed. Concurrent acquires of a cold model run ONE loader; the
        rest wait on it."""
        key = (name, version)
        with self._cond:
            resident = self._require_locked(name, version)
            while resident.loading:
                self._cond.wait()
                resident = self._require_locked(name, version)
            if resident.model is not None:
                self._clock += 1
                resident.last_used = self._clock
                return resident.model
            resident.loading = True
        # The load runs OUTSIDE the lock: loaders deserialize weights /
        # touch disk, and a slow cold start must not block acquires of
        # models that are already resident.
        t0 = time.monotonic()
        try:
            with telemetry.span(telemetry.SPAN_MODEL_LOAD, model=name,
                                version=version):
                model = place(resident.loader())
            nbytes = int(model.weight_bytes()) if hasattr(
                model, "weight_bytes") else 0
        except BaseException:
            with self._cond:
                resident.loading = False
                self._cond.notify_all()
            raise
        load_s = time.monotonic() - t0
        with self._cond:
            victims = self._plan_evictions_locked(nbytes, exclude=key)
            if victims is None:
                resident.loading = False
                self._cond.notify_all()
                pinned = sum(r.bytes for r in self._residents.values()
                             if r.pinned and r.model is not None)
                raise ResidencyExhausted(
                    f"cannot admit {name!r} v{version} ({nbytes} B): "
                    f"budget {self._budget} B cannot hold it beside "
                    f"{pinned} B of pinned residents")
            resident.model = model
            resident.bytes = nbytes
            self._clock += 1
            resident.last_used = self._clock
            resident.loading = False
            self._cold_starts += 1
            self._cond.notify_all()
        health.record(health.SERVING_COLD_START, model=name,
                      version=version, bytes=nbytes, seconds=load_s)
        while victims:
            # popped, so no reference of this frame outlives the release
            self._release(*victims.pop(0))
        return model

    # -- eviction ------------------------------------------------------------

    def evict(self, name: str, version: str) -> bool:
        """Force-evict one version (False if cold or pinned)."""
        key = (name, version)
        with self._cond:
            resident = self._require_locked(name, version)
            if resident.pinned or resident.model is None:
                return False
            model, nbytes = resident.model, resident.bytes
            resident.model = None
            resident.bytes = 0
        self._release(key, model, nbytes)
        return True

    def _plan_evictions_locked(self, incoming: int, exclude: Tuple
                               ) -> Optional[List[Tuple]]:
        """Pick victims so ``incoming`` fits the budget; clears them
        from the ledger and returns ``[(key, model, bytes), ...]`` for
        the caller to release OUTSIDE the lock. ``None`` = impossible
        (the pinned set + incoming exceed the budget)."""
        resident_total = sum(r.bytes for r in self._residents.values()
                             if r.model is not None)
        need = resident_total + incoming - self._budget
        if need <= 0:
            return []
        candidates = [r for key, r in self._residents.items()
                      if r.model is not None and not r.pinned
                      and key != exclude]
        if self._policy == "lru":
            candidates.sort(key=lambda r: r.last_used)
        else:  # weighted: biggest-coldest first
            candidates.sort(key=lambda r: r.bytes
                            * (self._clock - r.last_used + 1),
                            reverse=True)
        victims: List[Tuple] = []
        for r in candidates:
            if need <= 0:
                break
            victims.append(((r.name, r.version), r.model, r.bytes))
            need -= r.bytes
            r.model = None
            r.bytes = 0
        if need > 0:
            # roll the plan back: nothing is evicted on a failed admit
            for (name, version), model, nbytes in victims:
                row = self._residents[(name, version)]
                row.model = model
                row.bytes = nbytes
            return None
        return victims

    def _release(self, key: Tuple[str, str], model: Any,
                 nbytes: int) -> None:
        """Actually free an evicted model: executor coalescing states,
        captured graphs, telemetry. Runs WITHOUT the ledger lock (it
        takes the model's memo lock and the executor's state locks)."""
        variants = (model.device_variants()
                    if hasattr(model, "device_variants") else [model])
        executor.service().retire_model(model, variants=variants)
        if hasattr(model, "release_device_state"):
            model.release_device_state()
        with self._cond:
            self._evictions += 1
        telemetry.count(telemetry.M_SERVING_EVICTIONS)
        health.record(health.SERVING_EVICTED, model=key[0],
                      version=key[1], bytes=nbytes)

    # -- introspection -------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._cond:
            return sum(r.bytes for r in self._residents.values()
                       if r.model is not None)

    def resident_bytes_for(self, name: str, version: str) -> int:
        """Bytes one (model, version) currently holds resident (0 when
        cold, evicted, or unregistered)."""
        with self._cond:
            row = self._residents.get((name, version))
            return (row.bytes if row is not None
                    and row.model is not None else 0)

    def is_resident(self, name: str, version: str) -> bool:
        with self._cond:
            row = self._residents.get((name, version))
            return row is not None and row.model is not None

    def status(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "budget_bytes": self._budget,
                "policy": self._policy,
                "resident_bytes": sum(
                    r.bytes for r in self._residents.values()
                    if r.model is not None),
                "evictions": self._evictions,
                "cold_starts": self._cold_starts,
                "residents": [
                    {"model": r.name, "version": r.version,
                     "bytes": r.bytes, "pinned": r.pinned,
                     "resident": r.model is not None}
                    for r in self._residents.values()],
            }

    def _require_locked(self, name: str, version: str) -> _Resident:
        try:
            return self._residents[(name, version)]
        except KeyError:
            raise KeyError(
                f"(model={name!r}, version={version!r}) is not "
                "registered with the residency manager") from None
