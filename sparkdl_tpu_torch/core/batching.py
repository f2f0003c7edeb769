"""Fixed-shape batching: chunk rows, pad each chunk to its rung.

A port of ``sparkdl_tpu.core.batching``. On the card each bucket rung is
one captured CUDA graph (``ModelFunction.jitted``), as each is one
compiled program in the JAX package, so the rungs are few and fixed:
partitions are chunked at ``batch_size``, each chunk is zero-padded to
its rung (the power-of-two ladder, or a :class:`BucketPlanner`'s tuned
ladder), and the pad rows are dropped after compute.

:func:`run_batched` stages chunk ``k+1`` on a background thread
(``core.pipeline.DevicePrefetcher``) while the consumer drives the card
with chunk ``k``. On the card the staging thread pads each chunk into a
slot of a pinned host ring and does nothing else; the consumer copies
the slot to the card and hands the slot back only after a CUDA event
shows that copy finished.

Per-chunk failures are classified (``core.resilience``): a transient
error retries the same chunk with backoff (a ``chunk_retry`` health
event), a device OOM re-pads the chunk's valid rows at half its bucket
(an ``oom_rechunk`` event; on the card the smaller rung is one more
captured graph), and a fatal error, or an OOM at a bucket of one row,
propagates. Everything stays on the device: nothing re-runs on the CPU
or eagerly. The mesh ``multiple=`` and pytree inputs of the reference
are not ported yet.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, \
    Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.core import (
    health, kernels, pipeline, profiling, resilience, telemetry,
)

logger = logging.getLogger(__name__)


def pad_batch(arr: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Zero-pad dim 0 up to ``batch_size``; returns (padded, n_valid)."""
    n = arr.shape[0]
    if n == batch_size:
        return arr, n
    if n > batch_size:
        raise ValueError(f"batch of {n} rows exceeds batch_size {batch_size}")
    pad_widths = [(0, batch_size - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_widths), n


def bucket_size(n: int, batch_size: int, min_bucket: int = 8) -> int:
    """Smallest power-of-two bucket ≥ n, capped at ``batch_size`` (a tail
    chunk pads to its rung, not to the full batch); ``n`` above
    ``batch_size`` gets a bucket that covers it."""
    b = min_bucket
    while b < n:
        b <<= 1
    return max(min(b, batch_size), n)


def _chunks(n: int, batch_size: int, planner: Optional["BucketPlanner"]
            ) -> Iterator[Tuple[int, int, int]]:
    """(start, stop, bucket) of each chunk of ``n`` rows."""
    for start in range(0, n, batch_size):
        rows = min(batch_size, n - start)
        bucket = (planner.plan(rows) if planner is not None
                  else bucket_size(rows, batch_size))
        yield start, start + rows, bucket


def iter_batches(arr: np.ndarray, batch_size: int,
                 planner: Optional["BucketPlanner"] = None
                 ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (padded_chunk, n_valid) fixed-shape chunks over dim 0; the
    tail chunk pads to its bucket, not full batch_size — the power-of-two
    ladder by default, or ``planner``'s telemetry-tuned ladder."""
    for start, stop, bucket in _chunks(arr.shape[0], batch_size, planner):
        yield pad_batch(arr[start:stop], bucket)


def element_signature(array: np.ndarray) -> Tuple:
    """(element shape, dtype) of a dim-0-batched array: the identity
    under which rows are interchangeable."""
    return (tuple(array.shape[1:]), str(array.dtype))


# (id(fn), element signature) -> (a weak reference to fn, the output's
# element shape and numpy dtype). fn is held weakly, so the memo never
# keeps a discarded model alive; the stored reference also guards against
# an id() reused by another fn.
_EMPTY_TEMPLATES: Dict[Tuple, Tuple[Callable[[], Any], Tuple]] = {}
_EMPTY_LOCK = threading.Lock()


def _empty_result(fn: Callable, array: np.ndarray,
                  batch_size: int) -> np.ndarray:
    """Zero-row output with ``fn``'s output element shape and dtype (a
    bfloat16 output as float32, as :func:`run_batched` returns it).

    The shape comes from one pass of ``fn`` on meta tensors at
    ``batch_size`` rows (``fn.__sparkdl_trace_target__`` when present:
    the abstract version of a compiled fn, which would otherwise record a
    compile for a shape it never ran), memoized per (fn, element
    signature): every later empty call rebuilds the array from the
    memo."""
    key = (id(fn), element_signature(array))
    with _EMPTY_LOCK:
        hit = _EMPTY_TEMPLATES.get(key)
    if hit is None or hit[0]() is not fn:
        dtype = torch.from_numpy(np.zeros((0,), array.dtype)).dtype
        dummy = torch.empty((batch_size,) + tuple(array.shape[1:]),
                            dtype=dtype, device="meta")
        out = getattr(fn, "__sparkdl_trace_target__", fn)(dummy)
        out_dtype = (torch.float32 if out.dtype == torch.bfloat16
                     else out.dtype)
        template = (tuple(out.shape[1:]),
                    torch.empty(0, dtype=out_dtype).numpy().dtype)

        def _drop(_ref, _key=key):
            with _EMPTY_LOCK:
                _EMPTY_TEMPLATES.pop(_key, None)

        try:
            ref: Callable[[], Any] = weakref.ref(fn, _drop)
        except TypeError:  # not weakly referable: a strong reference
            ref = (lambda _fn=fn: _fn)
        with _EMPTY_LOCK:
            _EMPTY_TEMPLATES[key] = (ref, template)
    else:
        template = hit[1]
    shape, dtype = template
    return np.zeros((0,) + shape, dtype=dtype)


def _record_chunk_metrics(bucket: int, n_valid: int) -> None:
    """Feed the active telemetry scope's bucket-occupancy / padding-waste
    instruments. One global read when no scope is active."""
    tel = telemetry.active()
    if tel is None:
        return
    valid = tel.metrics.counter(telemetry.M_BATCH_ROWS)
    pad = tel.metrics.counter(telemetry.M_BATCH_PAD_ROWS)
    valid.inc(n_valid)
    pad.inc(bucket - n_valid)
    tel.metrics.histogram(telemetry.M_BATCH_BUCKET_ROWS,
                          telemetry.POW2_BOUNDS).observe(bucket)
    total = valid.value + pad.value
    if total:
        tel.metrics.gauge(telemetry.M_PADDING_WASTE).set(pad.value / total)


# ---------------------------------------------------------------------------
# Telemetry-tuned bucket ladder
# ---------------------------------------------------------------------------

#: Retune cadence: the ladder is re-solved every N observed launches.
PLANNER_UPDATE_EVERY = 64
#: Hysteresis: a candidate ladder is adopted only when it cuts the
#: predicted pad rows by at least this fraction vs the current ladder —
#: marginal wins never pay a new graph capture.
PLANNER_HYSTERESIS = 0.10
#: Hard bound on ladder adoptions per planner: with the rung count capped
#: at the power-of-two ladder's length, the graphs captured stay
#: O(log batch_size) for the process lifetime.
PLANNER_MAX_UPDATES = 8
#: Observed-size histogram bound (distinct sizes kept exactly; partition
#: sizes are highly repetitive in practice).
_PLANNER_MAX_SIZES = 128

_LADDER_STORE_BASENAME = "sparkdl_bucket_ladders.json"


def ladder_store_path() -> Optional[str]:
    """Learned-ladder persistence file in ``$SPARKDL_COMPILE_CACHE_DIR``
    (beside the kernel verdicts): a warm process reloads the tuned ladder,
    so the retune is paid once, not per process. None when the variable
    is unset (no persistence)."""
    cache_dir = os.environ.get(kernels.COMPILE_CACHE_DIR_ENV)
    if not cache_dir:
        return None
    return os.path.join(cache_dir, _LADDER_STORE_BASENAME)


def _pow2_ladder(batch_size: int, min_bucket: int) -> Tuple[int, ...]:
    """The blind ladder: every bucket ``bucket_size`` can return for
    n ≤ batch_size. Seeding the planner with it makes a cold planner
    identical to the unplanned path."""
    rungs = set()
    b = min_bucket
    n = 1
    while n <= batch_size:
        rungs.add(bucket_size(n, batch_size, min_bucket))
        if n == b:
            b <<= 1
        n = min(b, batch_size) if n < batch_size else batch_size + 1
    return tuple(sorted(rungs))


class BucketPlanner:
    """Per-model telemetry-tuned bucket ladder.

    Feeds on the launch-size stream (``plan``/``observe`` at each chunk)
    and every ``update_every`` observations re-solves the ladder to
    minimize predicted pad rows over the observed size distribution.
    Bounded: at most as many rungs as the power-of-two ladder, adoption
    gated on a ≥ ``PLANNER_HYSTERESIS`` predicted win (and at most
    ``PLANNER_MAX_UPDATES`` adoptions), so the graphs captured stay
    O(log batch_size). When a telemetry scope is active, each adoption
    bumps ``sparkdl.batching.bucket_ladder_update`` and sets the
    ``sparkdl.batching.planner_waste`` gauge to the predicted pad fraction
    under the new ladder. Thread-safe.
    """

    def __init__(self, batch_size: int, min_bucket: int = 8,
                 name: str = "model",
                 update_every: int = PLANNER_UPDATE_EVERY,
                 hysteresis: float = PLANNER_HYSTERESIS,
                 ladder: Optional[Tuple[int, ...]] = None) -> None:
        self.batch_size = int(batch_size)
        self.min_bucket = int(min_bucket)
        self.name = name
        self.update_every = max(1, int(update_every))
        self.hysteresis = float(hysteresis)
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._since_update = 0
        self._updates = 0
        self._cap = bucket_size(self.batch_size, self.batch_size,
                                self.min_bucket)
        base = _pow2_ladder(self.batch_size, self.min_bucket)
        self._ladder: Tuple[int, ...] = (
            tuple(sorted(set(ladder))) if ladder else base)
        # the top rung must cover every admissible n (≤ batch_size)
        if not self._ladder or self._ladder[-1] < self._cap:
            self._ladder = tuple(sorted(set(self._ladder) | {self._cap}))

    # -- lookup ---------------------------------------------------------------

    def ladder(self) -> Tuple[int, ...]:
        with self._lock:
            return self._ladder

    def bucket_for(self, n: int, cap: Optional[int] = None) -> int:
        """Smallest ladder rung ≥ n. ``cap`` below this planner's
        batch_size falls back to the blind ladder at that cap — a foreign
        cap must not graft new shapes onto the tuned ladder."""
        if cap is not None and cap < self.batch_size:
            return bucket_size(n, cap, self.min_bucket)
        with self._lock:
            for rung in self._ladder:
                if rung >= n:
                    return rung
        # n above the ladder (public-helper use): cover it
        return bucket_size(n, self.batch_size, self.min_bucket)

    def plan(self, n: int) -> int:
        """``observe`` + ``bucket_for`` — the one-call form the batching
        iterators use per chunk."""
        self.observe(n)
        return self.bucket_for(n)

    # -- learning -------------------------------------------------------------

    def observe(self, n: int) -> None:
        """Record one requested launch of ``n`` valid rows; retune every
        ``update_every`` observations."""
        if n <= 0 or n > self.batch_size:
            return
        retune = False
        with self._lock:
            if len(self._counts) < _PLANNER_MAX_SIZES or n in self._counts:
                self._counts[n] = self._counts.get(n, 0) + 1
            self._since_update += 1
            if (self._since_update >= self.update_every
                    and self._updates < PLANNER_MAX_UPDATES):
                self._since_update = 0
                retune = True
        if retune:
            self._retune()

    def _padded_rows(self, ladder: Tuple[int, ...],
                     counts: Dict[int, int]) -> float:
        total = 0.0
        for n, c in counts.items():
            rung = next((r for r in ladder if r >= n), self._cap)
            total += c * (rung - n)
        return total

    def _retune(self) -> None:
        """Re-solve the ladder over the observed size histogram (exact DP
        over candidate rungs), gated on hysteresis. Reads the live
        padding-waste gauge as a cheap trigger: when the measured waste is
        already negligible there is nothing to win."""
        tel = telemetry.active()
        if tel is not None:
            waste = tel.metrics.gauge(telemetry.M_PADDING_WASTE).value
            if waste is not None and waste < 0.02:
                return
        with self._lock:
            counts = dict(self._counts)
            current = self._ladder
            max_rungs = len(_pow2_ladder(self.batch_size, self.min_bucket))
        if not counts:
            return
        candidate = self._solve(counts, max_rungs)
        cost_now = self._padded_rows(current, counts)
        cost_new = self._padded_rows(candidate, counts)
        if (candidate == current
                or cost_new > (1.0 - self.hysteresis) * cost_now):
            return
        with self._lock:
            self._ladder = candidate
            self._updates += 1
        valid = float(sum(n * c for n, c in counts.items()))
        waste_after = (cost_new / (cost_new + valid)
                       if cost_new + valid else 0.0)
        logger.info("%s: bucket ladder retuned to %s (predicted pad "
                    "fraction %.3f)", self.name, candidate, waste_after)
        if telemetry.active() is not None:
            telemetry.count(telemetry.M_BUCKET_LADDER_UPDATE)
            telemetry.gauge_set(telemetry.M_PLANNER_WASTE, waste_after)
        _persist_ladder(self)

    def _solve(self, counts: Dict[int, int], max_rungs: int
               ) -> Tuple[int, ...]:
        """Pick ≤ max_rungs rungs minimizing total pad rows over the
        observed sizes. Candidates are the observed sizes plus the cap
        (always a rung, so any n ≤ batch_size stays coverable). Exact DP:
        for S candidates, O(S² · max_rungs) — S is small by
        construction."""
        cands = sorted({min(n, self._cap) for n in counts} | {self._cap})
        INF = float("inf")

        def seg_cost(lo: int, hi: int) -> float:
            # pad-to-hi cost of every observed size in (lo, hi]
            return sum(c * (hi - n) for n, c in counts.items()
                       if lo < n <= hi)

        S = len(cands)
        # dp[k][j]: min cost covering all sizes ≤ cands[j] with k rungs,
        # the highest being cands[j]
        dp = [[INF] * S for _ in range(max_rungs + 1)]
        choice: Dict[Tuple[int, int], int] = {}
        for j in range(S):
            dp[1][j] = seg_cost(0, cands[j])
        for k in range(2, max_rungs + 1):
            for j in range(S):
                best, arg = dp[k - 1][j], None  # k-1 rungs already enough
                for i in range(j):
                    c = dp[k - 1][i] + seg_cost(cands[i], cands[j])
                    if c < best:
                        best, arg = c, i
                dp[k][j] = best
                if arg is not None:
                    choice[(k, j)] = arg
        # top rung must be the cap rung (last candidate)
        j = S - 1
        k = max_rungs
        rungs = [cands[j]]
        while k > 1:
            arg = choice.get((k, j))
            if arg is None:
                k -= 1
                continue
            j = arg
            rungs.append(cands[j])
            k -= 1
        return tuple(sorted(set(rungs)))

    # -- persistence ----------------------------------------------------------

    def _store_key(self) -> str:
        # the reference's key; the trailing 1 is its mesh multiple
        return f"{self.name}|{self.batch_size}|1"


def _persist_ladder(planner: BucketPlanner) -> None:
    """Merge this planner's ladder into the store file (atomic replace;
    concurrent writers race whole-file, last wins — the ladder is a cache,
    not a source of truth)."""
    path = ladder_store_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc: Dict[str, Any] = {"version": 1, "ladders": {}}
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and loaded.get("version") == 1:
                doc = loaded
        except (OSError, ValueError):
            pass
        doc.setdefault("ladders", {})[planner._store_key()] = \
            list(planner.ladder())
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError as e:  # persistence is best-effort
        logger.warning("could not persist bucket ladder to %s: %s", path, e)


def _load_ladder(name: str, batch_size: int) -> Optional[Tuple[int, ...]]:
    path = ladder_store_path()
    if path is None:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        rungs = doc.get("ladders", {}).get(f"{name}|{batch_size}|1")
        if rungs and all(isinstance(r, int) and r > 0 for r in rungs):
            return tuple(sorted(set(rungs)))
    except (OSError, ValueError, AttributeError):
        pass
    return None


# Process-wide planner registry: one planner per (model, batch_size), so
# every partition of a model feeds (and benefits from) the same ladder.
_PLANNERS: Dict[Tuple, BucketPlanner] = {}
_PLANNER_LOCK = threading.Lock()


def planner_for(name: str, batch_size: int,
                min_bucket: int = 8) -> BucketPlanner:
    """The shared planner for one (model name, batch_size) ladder; created
    seeded with the persisted ladder when one exists."""
    key = (name, int(batch_size))
    with _PLANNER_LOCK:
        planner = _PLANNERS.get(key)
    if planner is not None:
        return planner
    # persisted-ladder file I/O stays OUTSIDE the lock; two racers build
    # equivalent planners and setdefault keeps exactly one
    planner = BucketPlanner(batch_size, min_bucket=min_bucket, name=name,
                            ladder=_load_ladder(name, batch_size))
    with _PLANNER_LOCK:
        return _PLANNERS.setdefault(key, planner)


def default_planner(name: str, batch_size: int
                    ) -> Optional[BucketPlanner]:
    """``planner_for`` gated on ``EngineConfig.bucket_ladder``: None under
    ``"pow2"`` (the blind ladder everywhere)."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    if EngineConfig.bucket_ladder != "tuned":
        return None
    return planner_for(name, batch_size)


def reset_planners() -> None:
    """Drop every learned ladder (test isolation)."""
    with _PLANNER_LOCK:
        _PLANNERS.clear()


# ---------------------------------------------------------------------------
# Pinned staging ring (the card's side of run_batched)
# ---------------------------------------------------------------------------

#: Slots of a consumer's copies a ring lets run ahead of their events.
_RING_IN_FLIGHT = 2


class _PinnedRing:
    """Slots of pinned host memory, each one bucket of ``batch_size``
    rows, that the staging thread pads chunks into.

    Slots: the prefetch queue's ``depth``, the one the producer fills,
    the one the consumer holds, and the ``_RING_IN_FLIGHT`` whose copies
    to the card may still run, so the producer never waits for a slot
    forever. The staging thread only writes host memory; the consumer
    allocates the ring, records an event after each slot's copy and
    returns the slot to the free list once the event has completed."""

    def __init__(self, depth: int, shape: Tuple[int, ...], dtype) -> None:
        self.slots = depth + _RING_IN_FLIGHT + 2
        self.key = (self.slots, shape, dtype)
        self._buf = torch.empty((self.slots,) + shape, dtype=dtype,
                                pin_memory=True)
        self._host = self._buf.numpy()
        self._free: "queue.Queue[int]" = queue.Queue()
        self._pending: Deque[Tuple[Any, int]] = collections.deque()
        self.reset()

    def reset(self) -> None:
        """Every slot free (the staging thread is joined and every copy
        has finished)."""
        self._pending.clear()
        self._free = queue.Queue()
        for slot in range(self.slots):
            self._free.put(slot)

    def stage(self, array: np.ndarray, start: int, stop: int,
              bucket: int) -> Tuple[int, torch.Tensor, int]:
        """Pad ``array[start:stop]`` into a free slot (staging thread);
        returns (slot, its first ``bucket`` rows, n_valid)."""
        slot, chunk = self.stage_parts([array[start:stop]], bucket)
        return slot, chunk, stop - start

    def stage_parts(self, parts: List[np.ndarray], bucket: int
                    ) -> Tuple[int, torch.Tensor]:
        """Concatenate ``parts`` along dim 0 into a free slot and pad it
        to ``bucket`` rows (the executor's coalesced window); returns
        (slot, its first ``bucket`` rows)."""
        slot = self._free.get()
        host = self._host[slot, :bucket]
        n = 0
        for part in parts:
            host[n:n + part.shape[0]] = part
            n += part.shape[0]
        host[n:] = 0
        return slot, self._buf[slot, :bucket]

    def retire(self, slot: int, stream) -> None:
        """The consumer has enqueued the copy out of ``slot`` on
        ``stream``: the slot is free once an event recorded after it
        completes."""
        event = torch.cuda.Event()
        event.record(stream)
        self._pending.append((event, slot))

    def reclaim(self) -> None:
        """Free the slots whose copies finished, waiting for the oldest
        while more than ``_RING_IN_FLIGHT`` are pending (consumer)."""
        while self._pending and (len(self._pending) > _RING_IN_FLIGHT
                                 or self._pending[0][0].query()):
            event, slot = self._pending.popleft()
            event.synchronize()
            self._free.put(slot)

    def drain(self) -> None:
        for event, _ in self._pending:
            event.synchronize()
        self.reset()


# Idle rings by (slots, shape, dtype): pinning host memory costs far more
# than a partition's padding, so rings are reused across calls.
_RINGS: Dict[Tuple, List[_PinnedRing]] = {}
_RINGS_LOCK = threading.Lock()
_RINGS_KEPT = 4


def _take_ring(depth: int, shape: Tuple[int, ...], dtype) -> _PinnedRing:
    key = (depth + _RING_IN_FLIGHT + 2, shape, dtype)
    with _RINGS_LOCK:
        idle = _RINGS.get(key)
        if idle:
            return idle.pop()
    return _PinnedRing(depth, shape, dtype)


def _give_ring(ring: _PinnedRing) -> None:
    ring.drain()
    with _RINGS_LOCK:
        idle = _RINGS.setdefault(ring.key, [])
        if len(idle) < _RINGS_KEPT:
            idle.append(ring)


# ---------------------------------------------------------------------------
# run_batched
# ---------------------------------------------------------------------------


def _dispatch_chunk(fn: Callable[[torch.Tensor, int], torch.Tensor],
                    array: np.ndarray, start: int, chunk: torch.Tensor,
                    n_valid: int, device: torch.device,
                    policy: resilience.RetryPolicy) -> List[torch.Tensor]:
    """Run one padded chunk (rows ``start:start + n_valid`` of
    ``array``) with classified retry and OOM re-chunking; returns its
    output rows on the device, in row order — one tensor normally,
    several when an OOM made the chunk re-run as smaller sub-chunks.

    - FATAL: propagate; retrying a shape or dtype error replays it.
    - RETRYABLE: bounded backoff retry of the same chunk through
      ``policy.execute`` (the same graph).
    - OOM: halve the bucket and re-pad THIS chunk's valid rows at it
      from the host array, recursing — the pad rows are zeros, so
      the per-row values are the same. An OOM at a bucket of one row
      propagates to ``apply_batch``'s whole-call re-run.
    """
    rows = chunk.shape[0]

    def attempt():
        resilience.inject("device_oom", rows=rows, valid=n_valid)
        resilience.inject("transfer_stall", rows=rows)
        return [fn(chunk, n_valid)]

    try:
        return policy.execute(
            attempt, what=f"chunk dispatch (bucket {rows})",
            on_retry=lambda a, e: health.record(
                health.CHUNK_RETRY, bucket=rows, attempt=a,
                error=type(e).__name__))
    except Exception as e:  # noqa: BLE001 - classified below
        if resilience.classify(e) != resilience.OOM:
            raise
        half = rows // 2
        if half < 1:
            raise
        health.record(health.OOM_RECHUNK, bucket=rows, half=half)
        logger.warning(
            "device OOM at bucket %d (%s); re-chunking %d valid "
            "row(s) at bucket %d", rows, e, n_valid, half)
        out: List[torch.Tensor] = []
        for sub_start in range(start, start + n_valid, half):
            sub_stop = min(sub_start + half, start + n_valid)
            padded, sub_valid = pad_batch(
                array[sub_start:sub_stop],
                bucket_size(sub_stop - sub_start, half))
            sub = torch.from_numpy(padded)
            if device.type == "cuda":
                sub = sub.pin_memory()
            out.extend(_dispatch_chunk(fn, array, sub_start, sub,
                                       sub_valid, device, policy))
        return out


def run_batched(fn: Callable[[torch.Tensor, int], torch.Tensor],
                array: np.ndarray, batch_size: int, device: torch.device,
                prefetch: int = 2,
                planner: Optional[BucketPlanner] = None,
                retry_policy: Optional[resilience.RetryPolicy] = None
                ) -> np.ndarray:
    """Apply ``fn`` over all rows of ``array`` in padded chunks; returns
    numpy.

    ``fn(chunk, n_valid)`` takes one padded chunk on the host (in pinned
    memory on the card) and returns its first ``n_valid`` output rows on
    ``device`` (``ModelFunction.jitted``). Host chunk staging runs
    ``prefetch`` chunks ahead on a background thread (0 = inline); a call
    of one chunk has nothing to stage ahead and stages inline. The
    per-chunk outputs are concatenated on the device and fetched with
    one device-to-host copy (a bfloat16 result as float32). Zero rows
    give a zero-row array of the output's element shape
    (:func:`_empty_result`). ``planner``: the telemetry-tuned bucket
    ladder in place of the power-of-two tail buckets. Each chunk goes
    through :func:`_dispatch_chunk` (classified retry, OOM re-chunk)
    under ``retry_policy``, by default
    ``resilience.DEFAULT_INFERENCE_POLICY``."""
    policy = (retry_policy if retry_policy is not None
              else resilience.DEFAULT_INFERENCE_POLICY)
    n = array.shape[0]
    if n == 0:
        return _empty_result(fn, array, batch_size)
    if n <= batch_size:
        prefetch = 0
    ring = (_take_ring(prefetch, (batch_size,) + tuple(array.shape[1:]),
                       torch.from_numpy(array[:0]).dtype)
            if device.type == "cuda" else None)

    def stage(item):
        t0 = time.perf_counter()
        start, stop, bucket = item
        if ring is not None:
            staged = (start,) + ring.stage(array, start, stop, bucket)
        else:
            padded, n_valid = pad_batch(array[start:stop], bucket)
            staged = (start, None, torch.from_numpy(padded), n_valid)
        profiling.add_phase_time(profiling.STAGE_BATCH,
                                 time.perf_counter() - t0)
        return staged

    outs: List[torch.Tensor] = []
    try:
        with torch.inference_mode(), pipeline.DevicePrefetcher(
                _chunks(n, batch_size, planner), stage_fn=stage,
                depth=prefetch, name="run_batched") as staged:
            for start, slot, chunk, n_valid in staged:
                _record_chunk_metrics(chunk.shape[0], n_valid)
                try:
                    outs.extend(_dispatch_chunk(fn, array, start, chunk,
                                                n_valid, device, policy))
                finally:
                    if ring is not None:
                        ring.retire(slot,
                                    torch.cuda.current_stream(device))
                if ring is not None:
                    ring.reclaim()
            result = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
            if result.dtype == torch.bfloat16:  # numpy has no bfloat16
                result = result.float()
            return result.cpu().numpy()
    finally:
        if ring is not None:
            _give_ring(ring)
