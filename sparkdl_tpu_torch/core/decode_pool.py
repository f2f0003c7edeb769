"""Multi-process host decode pool.

JPEG decode is the main host phase of files → ``readImages`` →
featurize, and on the Pillow path it holds the GIL for much of each
image, so the partition *threads* cannot spread it. With
``EngineConfig.decode_workers`` > 0 this module fans a partition's
image blobs out to that many spawned worker processes, which decode to
HWC uint8 and hand the pixels back through POSIX shared memory: only the
compressed blobs go out through a pipe, and only shapes and offsets
come back.

Design points (the reference's, ``sparkdl_tpu/core/decode_pool.py``):

- **Spawn, never fork**: the parent holds a CUDA context, which a
  forked child must not inherit. Workers are
  ``multiprocessing.get_context("spawn")`` processes that import only
  the image codec stack (``image/imageIO.py``, the native loader and
  Pillow): no torch, no device.
- **Order-preserving**: :meth:`DecodePool.decode` slices its blob list
  into contiguous chunks of at most 32, fans them out, and reassembles
  by slice position, so unequal decode times reorder nothing.
- **Bit-identical**: workers run the inline decoder
  (``imageIO.decodePoolChunk``: the same one native threaded batch call
  per fixed-geometry chunk, the same Pillow fallback); fault injection
  and health accounting stay in the SUBMITTING process; an exception
  the inline path would raise (an unsupported channel count) ships back
  typed and is raised at the submitting call site. Pool on and off give
  the same rows, the same ``decode_degraded`` events and the same
  failures. ``decode_workers=0`` (the default) never touches this
  module.
- **Crash-tolerant**: a worker that dies (the armed
  ``decode_pool_worker_crash`` injection point makes it ``os._exit(1)``
  mid-task) is seen by the waiters' poll and respawned (one
  ``decode_pool_respawn`` health event per death), and exactly the
  chunks it held are dispatched again; a chunk that dies
  :data:`_MAX_ATTEMPTS` times fails with
  :class:`~sparkdl_tpu_torch.core.resilience.DecodeWorkerLost`,
  classified RETRYABLE, so the engine's task retry replays the
  partition.
- **Bounded**: at most ``EngineConfig.decode_pool_inflight`` chunks
  (default ``2 × workers``) are in flight pool-wide; a fast submitter
  waits instead of growing the queues.
- **Clean shutdown**: :meth:`DecodePool.close` (also the context
  manager's exit, ``__del__`` and, for the process-wide pool, ``atexit``)
  poisons and joins every worker, drains every result pipe to EOF so
  every shared-memory segment is unlinked, stops the collector thread
  and fails the waiters still in flight: no process and no segment
  outlives it.
- **Observable**: a ``sparkdl.decode_pool`` span per decode call (under
  the calling partition task's span), each chunk's
  ``sparkdl.decode_chunk`` span measured in its worker and adopted under
  it, a queue-depth gauge, a workers-busy gauge and a per-blob decode
  time histogram (chunk-amortized, measured in the worker).

Each worker owns a PRIVATE task queue and a PRIVATE result pipe (one
writer per pipe, so a worker killed mid-delivery wedges no sibling; the
parent sees its death as EOF), multiplexed by one collector thread with
``multiprocessing.connection.wait``; a reaped worker's pipe is drained
to EOF before it is closed, so results already sent (and their
segments) are never dropped unadopted.

Shared memory: the WORKER creates one segment per chunk
(``sdlshm_<ownerpid>_<workerpid>_<seq>``), packs the decoded arrays
back to back, unregisters the segment from its own resource tracker
(ownership travels with the message) and closes its mapping; the
parent's collector attaches, copies the packed region out once, then
closes and unlinks. A result for a chunk already resolved or abandoned
is adopted the same way before it is dropped. A segment whose owner pid
is dead (an owner killed with SIGKILL) is swept at the next pool's
start.
"""

from __future__ import annotations

import atexit
import itertools
import logging
import multiprocessing as mp
import os
import re
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from queue import Empty
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.core import health, resilience, telemetry

logger = logging.getLogger(__name__)

# One spawn context for every pool.
_MP_CTX = mp.get_context("spawn")

# Waiter/submitter poll granularity: bounds worker-crash detection
# latency without a dedicated monitor thread.
_WAIT_POLL_S = 0.05
# Blobs per worker task: small enough that unequal per-blob decode times
# balance across workers, large enough to amortize the queue round trip.
_MAX_CHUNK = 32
# Total tries per chunk across worker deaths before the chunk fails with
# a (RETRYABLE) DecodeWorkerLost.
_MAX_ATTEMPTS = 3

# Idle-worker orphan watch: a worker blocked on its task queue wakes this
# often to check whether its owner (the submitting parent) still exists.
# A kill -9'd parent can never deliver the poison pill, so reparenting is
# the worker's only death signal — without it every orphaned worker
# lingers forever.
_ORPHAN_POLL_S = 5.0

# Run-scoped shared-memory naming: sdlshm_<ownerpid>_<workerpid>_<seq>
# (all hex). Embedding the OWNER pid in the name is what makes leaked
# segments attributable — a kill -9'd run's in-flight segments carry a
# dead pid, and the next pool startup sweeps them.
_SHM_PREFIX = "sdlshm"
_SHM_DIR = "/dev/shm"
_SHM_NAME_RE = re.compile(
    rf"^{_SHM_PREFIX}_([0-9a-f]+)_[0-9a-f]+_[0-9a-f]+$")
_shm_counter = itertools.count(1)

# True inside a spawned worker (set by _worker_main): a worker must never
# route its own decodes back into a pool (and EngineConfig in the fresh
# interpreter defaults to decode_workers=0 anyway — belt and braces).
_IN_WORKER = False


def _create_segment(owner_pid: int, size: int) -> shared_memory.SharedMemory:
    """A run-scoped segment named ``sdlshm_<ownerpid>_<workerpid>_<seq>``
    so :func:`sweep_orphaned_segments` can attribute (and reclaim) the
    segments a kill -9'd owner left behind. A name collision (pid reuse
    against a stale leftover) just advances the sequence number."""
    while True:
        name = (f"{_SHM_PREFIX}_{owner_pid:x}_{os.getpid():x}_"
                f"{next(_shm_counter):x}")
        try:
            return shared_memory.SharedMemory(name=name, create=True,
                                              size=size)
        except FileExistsError:  # stale leftover from a reused pid
            continue


def _pack_result(arrays: Sequence[Optional[np.ndarray]],
                 decode_s: Sequence[float],
                 owner_pid: int) -> Dict[str, Any]:
    """Worker-side: pack decoded HWC uint8 arrays into ONE shared-memory
    segment; the queue message carries only names/shapes/offsets."""
    meta: Dict[str, Any] = {
        "shapes": [None if a is None else tuple(a.shape) for a in arrays],
        "offsets": [None] * len(arrays),
        "decode_s": list(decode_s),
        "shm": None,
    }
    total = sum(a.nbytes for a in arrays if a is not None)
    if not total:
        return meta
    seg = _create_segment(owner_pid, total)
    try:
        off = 0
        for i, a in enumerate(arrays):
            if a is None:
                continue
            a = np.ascontiguousarray(a, dtype=np.uint8)
            dst = np.ndarray(a.shape, dtype=np.uint8, buffer=seg.buf,
                             offset=off)
            np.copyto(dst, a)
            meta["offsets"][i] = off
            off += a.nbytes
        meta["shm"] = seg.name
    finally:
        try:
            # ownership transfers to the parent with the result message:
            # without this, the worker's resource_tracker would warn (or
            # double-unlink) at worker exit for a segment the parent owns
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker API drift
            pass
        seg.close()
    return meta


def _adopt_result(meta: Dict[str, Any]) -> List[Optional[np.ndarray]]:
    """Parent-side: attach the chunk's segment, copy the packed region
    out in ONE memcpy, then close AND unlink — the segment's life ends
    here regardless of whether a waiter still wants the arrays.

    The returned arrays are consecutive views over that single flat
    uint8 buffer (``_pack_result`` packs them gap-free), which the
    columnar plane (``imageIO.imageArraysToStructColumn``) detects and
    wraps zero-copy into an Arrow binary child — so a decoded chunk
    costs exactly one copy between shm and the device transfer."""
    shapes = meta["shapes"]
    arrays: List[Optional[np.ndarray]] = [None] * len(shapes)
    name = meta.get("shm")
    if name is None:
        return arrays
    seg = shared_memory.SharedMemory(name=name)
    try:
        end = 0
        for shape, off in zip(shapes, meta["offsets"]):
            if shape is not None:
                end = max(end, off + int(np.prod(shape)))
        flat = np.frombuffer(seg.buf, dtype=np.uint8, count=end).copy()
        for i, shape in enumerate(shapes):
            if shape is None:
                continue
            off = meta["offsets"][i]
            arrays[i] = flat[off:off + int(np.prod(shape))].reshape(shape)
    finally:
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:  # pragma: no cover - double-free race
            pass
    return arrays


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, owned by someone else
        return True
    return True


def sweep_orphaned_segments() -> int:
    """Unlink decode-pool shm segments whose embedded owner pid is dead.

    Normal runs adopt-and-unlink every segment (and close() drains the
    stragglers), but a kill -9'd owner leaks its in-flight segments in
    /dev/shm forever. Pool startup calls this; it only ever touches
    names matching this module's ``sdlshm_`` scheme with a dead owner,
    so concurrent runs (live owners) are untouched, and unlink races
    between two sweepers are benign. Returns the number reclaimed.
    """
    try:
        entries = os.listdir(_SHM_DIR)
    except OSError:  # platform without /dev/shm: nothing to sweep
        return 0
    swept = 0
    for entry in entries:
        m = _SHM_NAME_RE.match(entry)
        if m is None or _pid_alive(int(m.group(1), 16)):
            continue
        try:
            os.unlink(os.path.join(_SHM_DIR, entry))
        except OSError:  # lost the race to another sweeper
            continue
        swept += 1
        logger.warning("decode pool: swept orphaned shm segment %s "
                       "(owner dead)", entry)
    if swept:
        health.record(health.DECODE_POOL_SHM_SWEPT, n=swept)
    return swept


def _worker_main(tasks: Any, conn: Any, owner_pid: int,
                 clock_conn: Any = None) -> None:
    """Worker process loop: decode chunks until the ``None`` poison pill.

    Runs in a fresh spawn interpreter: the import below pulls only
    numpy, Pillow and the native loader — never torch. Undecodable blobs degrade per row inside
    ``decodePoolChunk`` (``None`` rows); exceptions the INLINE decoder
    would raise (bad channel counts) ship back as a typed chunk error
    and re-raise in the submitting process — pool on/off fail
    identically. Results travel over this worker's PRIVATE ``conn``
    (one writer per pipe — no shared queue lock a dying worker could
    wedge); only the armed ``decode_pool_worker_crash`` marker kills
    the process.

    ``owner_pid`` is the spawning parent: it names this worker's shm
    segments (sweepability), and an idle worker polls for its death —
    a kill -9'd parent never sends the poison pill, so reparenting
    (``os.getppid() != owner_pid``) is the exit signal that keeps
    orphaned workers from living forever.
    """
    global _IN_WORKER
    _IN_WORKER = True
    from sparkdl_tpu_torch.image import imageIO  # one heavy import per worker

    # one NTP-style round trip against the parent's perf_counter_ns so
    # chunk spans measured here land on the coordinator's timeline
    # (offset 0 if the parent never answers — see clock_handshake)
    clock_offset = 0
    if clock_conn is not None:
        clock_offset = telemetry.clock_handshake(clock_conn)
        clock_conn.close()

    while True:
        try:
            task = tasks.get(timeout=_ORPHAN_POLL_S)
        except Empty:
            if os.getppid() != owner_pid:  # orphaned: owner died hard
                conn.close()
                return
            continue
        if task is None:
            conn.close()
            return
        task_id, blobs, target_size, channels, crash, ctx = task
        if crash:
            os._exit(1)  # injected worker crash: die without cleanup
        t0_ns = time.perf_counter_ns()
        try:
            arrays = imageIO.decodePoolChunk(
                blobs, target_size=target_size, channels=channels)
        except Exception as e:  # noqa: BLE001 - re-raised parent-side
            conn.send((task_id, {"error": (type(e).__name__, str(e))}))
            continue
        t1_ns = time.perf_counter_ns()
        per_blob = (t1_ns - t0_ns) / 1e9 / max(1, len(blobs))
        result = _pack_result(arrays, [per_blob] * len(blobs), owner_pid)
        if ctx is not None:
            # a ctx rides the task only when the submitter had an active
            # trace; timestamps rebased onto the parent's clock here so
            # the adopting side never needs this worker's offset
            result["span"] = telemetry.remote_span(
                telemetry.SPAN_DECODE_CHUNK,
                t0_ns + clock_offset, t1_ns + clock_offset,
                blobs=len(blobs))
        conn.send((task_id, result))


class _Chunk:
    """One fan-out unit: a contiguous slice of a decode call's blobs,
    plus everything needed to resubmit it after a worker crash."""

    __slots__ = ("blobs", "target_size", "channels", "ctx", "event",
                 "result", "error", "attempts")

    def __init__(self, blobs: List[Optional[bytes]], target_size,
                 channels, ctx=None) -> None:
        self.blobs = blobs
        self.target_size = target_size
        self.channels = channels
        self.ctx = ctx  # submitter's span context; None when tracing off
        self.event = threading.Event()
        self.result: Optional[List[Optional[np.ndarray]]] = None
        self.error: Optional[BaseException] = None
        self.attempts = 1


def _rebuild_error(type_name: str, msg: str) -> BaseException:
    """Reconstruct a worker-side exception in the parent, preserving the
    builtin type so ``resilience.classify`` sees what the inline path
    would have raised (a ValueError stays FATAL across the process
    boundary)."""
    import builtins

    etype = getattr(builtins, type_name, None)
    if isinstance(etype, type) and issubclass(etype, Exception):
        try:
            return etype(msg)
        except Exception:  # pragma: no cover - exotic ctor signature
            pass
    return RuntimeError(f"{type_name}: {msg}")


class _Worker:
    """One worker process plus its PRIVATE task queue, its PRIVATE
    result pipe, and the ids of the chunks dispatched to it.

    Private channels per worker (instead of shared queues) buy three
    guarantees: a crashed worker's in-queue tasks die WITH it (they are
    precisely re-dispatched from ``assigned`` — no blanket
    resubmission, no stale tasks outliving the crash); a process killed
    while blocked in ``Queue.get`` — which holds the queue's reader
    lock — wedges only its own abandoned queue, never its siblings';
    and a process killed MID-RESULT-DELIVERY corrupts only its own pipe
    (each pipe has exactly one writer, the worker's main thread — there
    is no shared result-queue write lock to die holding), which the
    collector sees as EOF and the reaper turns into a respawn."""

    __slots__ = ("proc", "queue", "conn", "clock", "assigned")

    def __init__(self, proc: Any, queue: Any, conn: Any,
                 clock: Any) -> None:
        self.proc = proc
        self.queue = queue
        self.conn = conn  # parent's read end; None once EOF-drained
        self.clock = clock  # clock-handshake pipe; None once answered
        self.assigned: set = set()


class DecodePool:
    """N spawn-context decode worker processes, each with a PRIVATE task
    queue in and a PRIVATE result pipe back (multiplexed by one
    collector thread — see the module docstring's crash-safety
    rationale; there is no shared channel a dying worker can wedge).

    ::

        with DecodePool(workers=8) as pool:
            arrays = pool.decode(blobs, target_size=(224, 224), channels=3)

    ``decode`` is thread-safe: concurrent partition tasks share the pool
    (and the ``decode_pool_inflight`` backpressure bound). Callers
    normally never construct one — :func:`maybe_pool` manages the
    process-wide instance from ``EngineConfig.decode_workers``.
    """

    def __init__(self, workers: int,
                 inflight: Optional[int] = None) -> None:
        if workers < 1:
            raise ValueError(f"decode pool needs >= 1 worker, got {workers}")
        self.workers = int(workers)
        self.inflight = int(inflight) if inflight else 2 * self.workers
        if self.inflight < 1:
            raise ValueError(
                f"decode_pool_inflight must be >= 1, got {inflight!r}")
        # reclaim what a previous kill -9'd run left behind BEFORE this
        # run starts creating its own segments
        sweep_orphaned_segments()
        self._lock = threading.Lock()
        self._pending: Dict[int, _Chunk] = {}
        self._ids = itertools.count(1)
        self._sem = threading.BoundedSemaphore(self.inflight)
        self._closed = False
        self.respawns = 0  # worker deaths survived (tests/debugging)
        # parent-internal wakeup pipe: nudges the collector out of its
        # connection.wait when the conn list changes (respawn) or the
        # pool closes
        self._wake_r, self._wake_w = _MP_CTX.Pipe(duplex=False)
        # conns of reaped (replaced) workers, kept until the collector
        # drains them to EOF: a dead worker may have delivered results
        # — with live shared-memory names — that are still buffered in
        # its pipe, and dropping the conn would leak the segments
        self._retired_conns: List[Any] = []
        # clock pipes of reaped workers: drained to EOF by the collector
        # (a worker may die before pinging, or with a ping buffered)
        self._retired_clocks: List[Any] = []
        # incremental append (not a comprehension): a spawn failing at
        # worker k must leave workers 0..k-1 reachable so the cleanup
        # below can poison/join them instead of leaking live processes
        self._workers: List[_Worker] = []
        try:
            for i in range(self.workers):
                self._workers.append(self._spawn(i))
        except BaseException:
            for worker in self._workers:
                worker.queue.put(None)
                worker.proc.join(timeout=10.0)
                worker.queue.cancel_join_thread()
                worker.queue.close()
                worker.conn.close()
                if worker.clock is not None:
                    worker.clock.close()
            self._wake_r.close()
            self._wake_w.close()
            self._closed = True
            raise
        self._collector = threading.Thread(
            target=self._collect, name="sparkdl-decode-pool-collector",
            daemon=True)
        self._collector.start()

    def _spawn(self, index: int) -> _Worker:
        queue = _MP_CTX.Queue()
        recv_conn, send_conn = _MP_CTX.Pipe(duplex=False)
        # dedicated duplex pipe for the one-shot clock handshake: the
        # collector answers the worker's ping with perf_counter_ns
        clock_parent, clock_child = _MP_CTX.Pipe()
        proc = _MP_CTX.Process(
            target=_worker_main,
            args=(queue, send_conn, os.getpid(), clock_child),
            name=f"sparkdl-decode-{index}", daemon=True)
        proc.start()
        # drop the parent's copy of the write end: the worker owns the
        # only writer, so worker death shows up as EOF on recv_conn
        send_conn.close()
        clock_child.close()
        return _Worker(proc, queue, recv_conn, clock_parent)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- the public decode call ----------------------------------------------

    def decode(self, blobs: Sequence[Optional[bytes]],
               target_size: Optional[Tuple[int, int]] = None,
               channels: Optional[int] = None
               ) -> List[Optional[np.ndarray]]:
        """Decode ``blobs`` to HWC uint8 arrays, in submission order.

        ``None``/undecodable blobs come back as ``None`` rows (the
        tolerant contract — the caller owns health accounting). With
        ``target_size`` and ``channels`` both set the workers run the
        fused-resize batch decoder; otherwise each blob keeps its source
        geometry/channels (the ``readImages`` default-decoder contract).
        """
        if not blobs:
            return []
        with telemetry.span(telemetry.SPAN_DECODE_POOL, blobs=len(blobs)):
            per = max(1, min(_MAX_CHUNK,
                             -(-len(blobs) // (self.workers * 2))))
            chunks = [self._submit(list(blobs[s:s + per]), target_size,
                                   channels)
                      for s in range(0, len(blobs), per)]
            out: List[Optional[np.ndarray]] = []
            for chunk in chunks:
                out.extend(self._await(chunk))
            return out

    # -- submission / waiting ------------------------------------------------

    def _submit(self, blobs: List[Optional[bytes]], target_size,
                channels) -> _Chunk:
        # bounded in-flight: backpressure here, with crash detection so
        # a dead pool cannot wedge a submitter forever
        while not self._sem.acquire(timeout=_WAIT_POLL_S):
            if self._closed:
                raise resilience.DecodeWorkerLost(
                    "decode pool closed while a submit was waiting for "
                    "an in-flight slot")
            self._reap_crashed()
        chunk = _Chunk(blobs, target_size, channels,
                       telemetry.current_context())
        with self._lock:
            if self._closed:
                self._sem.release()
                raise resilience.DecodeWorkerLost(
                    "decode pool closed before the chunk was submitted")
            task_id = next(self._ids)
            self._pending[task_id] = chunk
            depth = len(self._pending)
            self._dispatch_locked(task_id, chunk)
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_DECODE_POOL_DEPTH, depth)
            telemetry.gauge_set(telemetry.M_DECODE_POOL_BUSY,
                                min(depth, self.workers))
        return chunk

    def _dispatch_locked(self, task_id: int, chunk: _Chunk) -> None:
        """Hand a chunk to the least-loaded worker (caller holds the
        lock). The injected ``decode_pool_worker_crash`` marker rides on
        the task, so the chosen worker dies while holding exactly this
        chunk — the respawn path's precise-resubmission bookkeeping is
        what the injection exercises."""
        worker = min(self._workers, key=lambda w: len(w.assigned))
        worker.assigned.add(task_id)
        crash = resilience.should_fire("decode_pool_worker_crash")
        worker.queue.put((task_id, chunk.blobs, chunk.target_size,
                          chunk.channels, crash, chunk.ctx))

    def _await(self, chunk: _Chunk) -> List[Optional[np.ndarray]]:
        while not chunk.event.wait(_WAIT_POLL_S):
            self._reap_crashed()
        if chunk.error is not None:
            raise chunk.error
        return chunk.result  # type: ignore[return-value]

    # -- crash detection / respawn -------------------------------------------

    def _reap_crashed(self) -> None:
        """Respawn dead workers and re-dispatch exactly the chunks they
        held.

        The per-worker queues make the loss set precise: a dead worker's
        ``assigned`` ids (intersected with still-pending chunks — it may
        have delivered a result just before dying) are the ONLY chunks
        re-dispatched, each with its attempt counter bumped; its queue —
        including any not-yet-consumed tasks, which are in the loss set
        — is abandoned with it. A chunk whose resubmission budget is
        spent fails with a RETRYABLE DecodeWorkerLost so the engine's
        classified task retry replays the whole partition. A duplicate
        result (the worker delivered AND died) is adopted and dropped by
        the collector, so shared memory never leaks whichever side wins.
        """
        dead: List[str] = []
        redispatch: List[Tuple[int, _Chunk]] = []
        failed: List[_Chunk] = []
        with self._lock:
            if self._closed:
                return
            for i, worker in enumerate(self._workers):
                if worker.proc.is_alive():
                    continue
                if worker.conn is not None:
                    # hand the dead worker's pipe to the collector: any
                    # buffered results (and their shm segments) must
                    # still be drained before the conn is closed
                    self._retired_conns.append(worker.conn)
                if worker.clock is not None:
                    # likewise the clock pipe: a buffered ping (or the
                    # death EOF) must be consumed, never left to leak
                    self._retired_clocks.append(worker.clock)
                # abandon the dead worker's task queue WITHOUT joining
                # its feeder thread: with >1 pipe-buffer of pickled
                # tasks queued to a worker that will never read them,
                # the feeder blocks in write forever, and the default
                # Queue finalizer would join it (= hang) at exit
                worker.queue.cancel_join_thread()
                worker.queue.close()
                self._workers[i] = self._spawn(i)
                dead.append(worker.proc.name)
                self.respawns += 1
                for task_id in sorted(worker.assigned):
                    chunk = self._pending.get(task_id)
                    if chunk is None:
                        continue  # delivered just before dying
                    chunk.attempts += 1
                    if chunk.attempts > _MAX_ATTEMPTS:
                        del self._pending[task_id]
                        failed.append(chunk)
                    else:
                        redispatch.append((task_id, chunk))
            if not dead:
                return
            for task_id, chunk in redispatch:
                self._dispatch_locked(task_id, chunk)
        # the collector may be blocked in connection.wait on the OLD conn
        # list; nudge it so the respawned workers' pipes are watched
        self._wake_w.send_bytes(b"r")
        for name in dead:
            logger.warning(
                "decode pool worker %s died; respawned (re-dispatched %d "
                "of its chunk(s))", name, len(redispatch))
            health.record(health.DECODE_POOL_RESPAWN, worker=name)
        for chunk in failed:
            chunk.error = resilience.DecodeWorkerLost(
                f"decode pool worker died {_MAX_ATTEMPTS} times while "
                "this chunk was in flight")
            chunk.event.set()
            self._sem.release()

    # -- the collector thread ------------------------------------------------

    def _collect(self) -> None:
        """Multiplex every worker's private result pipe. EOF on a pipe
        (worker exited — poison pill, crash, or killed mid-send) retires
        that conn after its buffered results are drained; crash respawn
        itself stays the waiters' reaper's job. Exits once the pool is
        closed and every conn has been drained to EOF — which is exactly
        the drain-everything guarantee the shared-memory lifecycle
        needs."""
        from multiprocessing import connection as _mpc

        while True:
            with self._lock:
                conn_map = {w.conn: w for w in self._workers
                            if w.conn is not None}
                clock_map = {w.clock: w for w in self._workers
                             if w.clock is not None}
                retired = list(self._retired_conns)
                retired_clocks = list(self._retired_clocks)
                done = (self._closed and not conn_map and not clock_map
                        and not retired and not retired_clocks)
            if done:
                return
            for ready in _mpc.wait(list(conn_map) + list(clock_map)
                                   + retired + retired_clocks
                                   + [self._wake_r]):
                if ready is self._wake_r:
                    try:
                        self._wake_r.recv_bytes()
                    except (EOFError, OSError):  # pragma: no cover
                        pass
                    continue
                if ready in clock_map or ready in retired_clocks:
                    # one-shot clock handshake: answer the worker's ping
                    # with THIS process's perf_counter_ns, then retire
                    # the pipe (EOF here means the worker died first; a
                    # send to a reaped worker's pipe fails harmlessly)
                    try:
                        ready.recv()
                        ready.send(time.perf_counter_ns())
                    except (EOFError, OSError):
                        pass
                    ready.close()
                    with self._lock:
                        worker = clock_map.get(ready)
                        if worker is not None and worker.clock is ready:
                            worker.clock = None
                        if ready in self._retired_clocks:
                            self._retired_clocks.remove(ready)
                    continue
                try:
                    task_id, meta = ready.recv()
                except (EOFError, OSError):
                    # worker exited; its buffered results were already
                    # delivered in order before EOF (the waiters' poll
                    # respawns crashed workers)
                    ready.close()
                    with self._lock:
                        worker = conn_map.get(ready)
                        if worker is not None and worker.conn is ready:
                            worker.conn = None
                        if ready in self._retired_conns:
                            self._retired_conns.remove(ready)
                    continue
                self._resolve(task_id, meta)

    def _resolve(self, task_id: int, meta: Dict[str, Any]) -> None:
        error = meta.get("error")
        # adopt (and free) the segment BEFORE looking the chunk up:
        # duplicates and abandoned chunks must still unlink
        arrays = None if error is not None else _adopt_result(meta)
        with self._lock:
            chunk = self._pending.pop(task_id, None)
            depth = len(self._pending)
            for worker in self._workers:
                worker.assigned.discard(task_id)
        if chunk is None:
            return  # crash-resubmission duplicate, already resolved
        if error is not None:
            # what the inline decoder would have raised, re-raised at
            # the submitting call site with its builtin type intact
            chunk.error = _rebuild_error(*error)
        else:
            chunk.result = arrays
        chunk.event.set()
        self._sem.release()
        tel = telemetry.active()
        if tel is not None:
            telemetry.gauge_set(telemetry.M_DECODE_POOL_DEPTH, depth)
            telemetry.gauge_set(telemetry.M_DECODE_POOL_BUSY,
                                min(depth, self.workers))
            rec = meta.get("span")
            if rec is not None and chunk.ctx is not None:
                # adopt the worker-measured chunk span under the context
                # captured at submit time — the worker has no tracer, so
                # the span id is allocated here
                tel.tracer.record_remote(
                    rec["name"], chunk.ctx, rec["start_ns"],
                    rec["end_ns"], pid=rec["pid"],
                    process=f"decode-{rec['pid']}",
                    **rec.get("attributes", {}))
            for dt in meta.get("decode_s", ()):
                telemetry.observe(telemetry.M_DECODE_POOL_DECODE_S, dt)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Join and reap everything: workers, collector, queues, shared
        memory. Idempotent; safe mid-stream (waiters fail with a
        RETRYABLE DecodeWorkerLost rather than hanging)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            abandoned = list(self._pending.values())
            self._pending.clear()
            workers = list(self._workers)
        for worker in workers:
            worker.queue.put(None)  # poison pill on each private queue
        for worker in workers:
            worker.proc.join(timeout=10.0)
            if worker.proc.is_alive():  # pragma: no cover - wedged worker
                worker.proc.terminate()
                worker.proc.join(timeout=10.0)
            # a dead worker never consumed its pill; don't let the
            # queue's feeder thread block interpreter exit on it
            worker.queue.cancel_join_thread()
            worker.queue.close()
        # the joins above closed every worker's pipe write end, so the
        # collector drains each conn to EOF — adopting and unlinking
        # every remaining segment — then sees closed + no live conns and
        # exits; the wake byte covers it being parked on an empty list
        self._wake_w.send_bytes(b"c")
        self._collector.join()
        for chunk in abandoned:
            chunk.error = resilience.DecodeWorkerLost(
                "decode pool closed mid-stream")
            chunk.event.set()
            self._sem.release()
        self._wake_w.close()
        self._wake_r.close()

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:  # safety net only; callers use close()/with
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# ---------------------------------------------------------------------------
# The process-wide pool (EngineConfig.decode_workers is the ONE knob)
# ---------------------------------------------------------------------------

_pool_lock = threading.Lock()
_pool: Optional[DecodePool] = None
_pool_key: Optional[Tuple[int, Optional[int]]] = None


def maybe_pool() -> Optional[DecodePool]:
    """The process-wide pool per ``EngineConfig.decode_workers``, or
    ``None`` when the pool is disabled (``decode_workers=0``, the
    bit-identical inline default) or when called from inside a worker.
    Reconfiguring the knobs closes the old pool and spawns a new one."""
    if _IN_WORKER:
        return None
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    EngineConfig.validate()
    workers = EngineConfig.decode_workers
    if not workers:
        return None
    key = (workers, EngineConfig.decode_pool_inflight)
    global _pool, _pool_key
    with _pool_lock:
        stale = _pool
        if stale is not None and _pool_key == key and not stale.closed:
            return stale
        _pool = None
    if stale is not None:
        stale.close()  # outside the lock: close() joins processes
    with _pool_lock:
        if _pool is None or _pool_key != key or _pool.closed:
            _pool = DecodePool(workers,
                               inflight=EngineConfig.decode_pool_inflight)
            _pool_key = key
        return _pool


def shutdown() -> None:
    """Close the process-wide pool (tests, bench mode flips, atexit)."""
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.close()


atexit.register(shutdown)
