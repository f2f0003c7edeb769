"""Asynchronous host-side staging pipeline.

A port of ``sparkdl_tpu.core.pipeline``: host ETL for chunk ``k+1``
(padding a partition's chunk into its bucket, in a pinned host buffer on
the card) runs on a background staging thread while the consumer drives
the card with chunk ``k``. Staging is pure: the values and their order
are those of the serial loop, only the thread that prepares them moves.

- **Bounded**: at most ``depth`` staged items wait in the queue, plus the
  one the producer holds while blocked on ``put`` — memory stays
  O(depth) chunks, never the partition.
- **Order-preserving**: ONE staging thread consumes the source iterator
  in order and a FIFO queue delivers in order.
- **Error propagation**: an exception anywhere in the source iterator or
  ``stage_fn`` is caught on the staging thread, delivered to the
  consumer at its next ``__next__``, and re-raised there with the
  staging thread joined — no leaked thread, no swallowed error.
- **Clean shutdown**: ``close()`` (or leaving the ``with`` block, or
  dropping the iterator early) wakes a producer blocked on a full queue,
  joins the thread, and drops staged items.
- **Observable**: per-stream counters (items staged, consumer stalls and
  stall seconds, producer-ahead hits, max queue depth) feed the
  ``sparkdl.host_wait`` phase timer (core.profiling) and, for streams
  that ask, one ``prefetch_report`` health event.

``depth=0`` is synchronous inline staging on the caller's thread (no
thread is created) — the same iteration contract, no overlap.

The staging thread prepares host buffers only: every CUDA call stays on
the consumer's thread (``core/batching.py`` hands the staging thread a
pinned slot whose previous copy to the card has finished).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional

from sparkdl_tpu_torch.core import health, profiling, telemetry


class _Done:
    """Sentinel: the source iterator is exhausted."""


class _Raised:
    """Sentinel wrapper: the staging thread raised; deliver to consumer."""

    def __init__(self, error: BaseException) -> None:
        self.error = error


@dataclass
class PrefetchStats:
    """Counters for one prefetch stream (all monotonic, thread-safe via
    the prefetcher's lock)."""

    staged: int = 0          # items produced by the staging thread
    consumed: int = 0        # items delivered to the consumer
    stalls: int = 0          # consumer waits on an empty queue (starvation)
    stall_s: float = 0.0     # total seconds the consumer waited
    ready_hits: int = 0      # items that were staged BEFORE being requested
    max_depth: int = 0       # high-water mark of staged-and-waiting items
    stage_s: float = 0.0     # total seconds spent in stage_fn + source pull

    def as_dict(self) -> dict:
        return {
            "staged": self.staged, "consumed": self.consumed,
            "stalls": self.stalls, "stall_s": round(self.stall_s, 6),
            "ready_hits": self.ready_hits, "max_depth": self.max_depth,
            "stage_s": round(self.stage_s, 6),
        }


# Wake-up granularity for a producer blocked on a full queue: close() is
# noticed within this bound without busy-waiting.
_PUT_POLL_S = 0.05


class DevicePrefetcher:
    """Bounded background staging stage over any ``(item, ...)`` iterable.

    ::

        with DevicePrefetcher(chunks, stage_fn=pad, depth=2) as staged:
            for host_chunk, n_valid in staged:
                out = fn(host_chunk)          # CUDA work: consumer thread

    ``source``: any iterable, generators included: the whole pull+stage
    chain runs on the staging thread, overlapping the card's work driven
    from the consumer's thread. ``stage_fn(item) -> staged`` runs on the
    staging thread too (host work only; identity when None). ``depth``:
    staged items buffered ahead (0 = inline synchronous staging, no
    thread). One stream is ONE pass — build a fresh prefetcher per pass.
    """

    def __init__(self, source: Iterable[Any],
                 stage_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, name: str = "prefetch",
                 report_health: bool = False) -> None:
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.name = name
        self.depth = depth
        # Event-log hygiene: only long-lived named streams emit the
        # prefetch_report health EVENT — one from every run_batched call
        # would flood HealthMonitor's bounded first-N event log. Stall
        # time always feeds the global sparkdl.host_wait phase timer.
        self._report_health = report_health
        self.stats = PrefetchStats()
        self._stage_fn = stage_fn
        self._lock = threading.Lock()
        self._closed = False
        self._reported = False
        self._inline: Optional[Iterator[Any]] = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Cross-thread trace handoff (core.telemetry): spans opened on
        # the staging thread (stage_fn's annotate calls, the source's
        # decode phases) parent under the CONSUMER's span that built
        # this prefetcher, keeping one run trace across threads.
        self._trace_ctx = telemetry.current_context()
        if depth == 0:
            self._inline = iter(source)
            return
        self._queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),),
            name=f"sparkdl-prefetch-{name}", daemon=True)
        self._thread.start()

    # -- staging thread ------------------------------------------------------

    def _produce(self, it: Iterator[Any]) -> None:
        out: Any = _Done
        telemetry.attach(self._trace_ctx)  # fresh thread: safe to adopt
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                if self._stage_fn is not None:
                    item = self._stage_fn(item)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.stats.staged += 1
                    self.stats.stage_s += dt
                    if self._queue.qsize() + 1 > self.stats.max_depth:
                        self.stats.max_depth = self._queue.qsize() + 1
                if telemetry.active() is not None:
                    telemetry.gauge_set(telemetry.M_PREFETCH_DEPTH,
                                        self._queue.qsize() + 1)
                if not self._put(item):
                    return  # closed while waiting for queue room
        except BaseException as e:  # noqa: BLE001 - delivered to consumer
            out = _Raised(e)
        # deliver the terminal sentinel (drop it if the consumer closed)
        self._put(out)

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._inline is not None:  # depth == 0: synchronous staging
            if self._closed:
                raise StopIteration
            # the consumer waits out the ENTIRE host pull+stage inline —
            # serial staging is 100% starvation, so the whole duration
            # feeds HOST_WAIT (overlap_ratio → 0, the serial baseline;
            # the threaded path only records actual queue waits)
            t0 = time.perf_counter()
            try:
                item = next(self._inline)
            except StopIteration:
                self._finish()
                raise
            staged = (self._stage_fn(item)
                      if self._stage_fn is not None else item)
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats.staged += 1
                self.stats.consumed += 1
                self.stats.stalls += 1
                self.stats.stall_s += dt
                self.stats.stage_s += dt
            profiling.add_phase_time(profiling.HOST_WAIT, dt)
            telemetry.observe(telemetry.M_PREFETCH_STALL_S, dt)
            return staged
        if self._closed:
            raise StopIteration
        try:
            item = self._queue.get_nowait()
            with self._lock:
                self.stats.ready_hits += 1
        except queue.Empty:
            # starvation: the device-driving thread is waiting on host ETL
            t0 = time.perf_counter()
            item = self._queue.get()
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats.stalls += 1
                self.stats.stall_s += dt
            profiling.add_phase_time(profiling.HOST_WAIT, dt)
            telemetry.observe(telemetry.M_PREFETCH_STALL_S, dt)
        if item is _Done:
            self._finish()
            raise StopIteration
        if isinstance(item, _Raised):
            self._finish()
            raise item.error
        with self._lock:
            self.stats.consumed += 1
        return item

    # -- lifecycle -----------------------------------------------------------

    def _finish(self) -> None:
        """Normal end of stream: join the (already exiting) thread.
        Shares close()'s atomic check-and-set: a close() racing the
        consumer's end-of-stream (e.g. __del__ on the GC thread) must
        not null _thread between this method's check and its join."""
        with self._lock:
            if self._closed:
                return  # a racing close() already joined and reported
            self._closed = True
        if self._thread is not None:
            self._thread.join()
            with self._lock:
                self._thread = None
        self._report()

    def close(self) -> None:
        """Abort the stream: wake + join the staging thread, drop staged
        items. Idempotent; safe mid-stream and after exhaustion — the
        closed check-and-set is atomic under the lock, so two racing
        closers (consumer + __del__, or two threads sharing the
        prefetcher) can't both run the join/drain/report sequence."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self._stop.set()
            # drain so a producer blocked on put() can notice stop quickly
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join()
            with self._lock:
                self._thread = None
        self._report()

    def _report(self) -> None:
        with self._lock:
            if self._reported or not self._report_health:
                return
            self._reported = True
        health.record(health.PREFETCH_REPORT, name=self.name,
                      depth=self.depth, **self.stats.as_dict())

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:  # safety net only; callers use close()/with
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
