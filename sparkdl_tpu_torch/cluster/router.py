"""Partition router: one engine job fanned across N worker processes.

The port of ``sparkdl_tpu.cluster.router``.
``engine/dataframe.py`` swaps its in-process ``_run_partition`` for
:meth:`ClusterRouter.run_partition` when ``EngineConfig.cluster_workers``
is set (the ONE knob; 0 keeps today's path byte-identical and never
imports this package). The router deliberately routes **through the
existing supervisor** — each partition still runs under
``engine/supervisor.py``'s classified retry, per-task deadline,
hedging, and quarantine; only the innermost "run the op chain" step is
replaced by a remote dispatch. That preserves every resilience
semantic across the process boundary for free:

- **retry**: a worker-side exception ships back typed with its
  ``resilience.classify`` kind and re-raises in the coordinator's
  retry loop — a retried attempt re-enters :meth:`run_partition`'s
  dispatch and picks a worker afresh.
- **hedging**: a hedge is just a second supervisor attempt; dispatch
  excludes workers already holding an in-flight attempt of the same
  partition, so the hedge lands on a *different* worker (a straggling
  worker cannot slow its own hedge).
- **quarantine**: FATAL confirmation replays route through dispatch
  like any retry; the partition-drop decision stays coordinator-side.
- **deadlines**: the supervisor watchdog's ``cancelled`` event makes
  the coordinator-side wait abandon (the worker's result, if it ever
  arrives, is dropped by the collector as an already-resolved task).

Assignment is load-aware on **outstanding rows** per worker (ties:
fewest in-flight tasks), the cluster analogue of the decode pool's
least-loaded pick but weighted by actual row counts so one huge
partition doesn't get a second one stacked behind it.

Worker death is detected as EOF on the dead worker's PRIVATE result
pipe (one writer per pipe — the decode-pool transport rationale). The
loss set is precise: exactly the dead worker's in-flight task ids,
re-dispatched to survivors (each re-dispatch is a
``cluster_redispatch`` health event + ``sparkdl.cluster.redispatch``
count; the death itself is ONE ``cluster_worker_lost``). With no
survivors the in-flight partitions fail with
:class:`~sparkdl_tpu_torch.core.resilience.ClusterWorkerLost` — classified
RETRYABLE, so the supervisor's task retry re-dispatches once workers
are back (or fails the job with the full attempt history). With
``EngineConfig.durable_dir`` set, the journal wraps OUTSIDE this
router (``dataframe._durable_runner``), so partitions committed before
a death are never re-dispatched at all — re-dispatch is zero-recompute
for them by construction.

At :meth:`close`, each worker ships its end-of-run snapshot
(``cluster/worker.py`` protocol), and the router merges them via
``cluster/aggregate.py`` into :attr:`cluster_report` (plus
:attr:`run_report` when a telemetry scope is active) — module-level
:func:`last_cluster_report` / :func:`last_run_report` keep the merged
view readable after :func:`shutdown`, and the workers' kernel launch
counts, forwards and reserved memory sum there (``device``).

On the card the router builds every kernel library (``cuda_build.
build_all``) before it spawns a worker; a worker only loads them. The op
chains and the boot snapshot travel through ``cluster/transport.py``
(closures by value, weights as CPU arrays); an op that cannot be
pickled fails its task naming the op, and never runs here instead.

The cluster serving plane (``serving/cluster.py``) rides the same
workers: it attaches itself as the router's serving handler
(:meth:`ClusterRouter.serving_attach`) and sends ``srv_*`` messages
through :meth:`~ClusterRouter.serving_send`. The router routes the
workers' ``srv_*`` replies, the exact serving request ids a dead worker
owed, replica top-ups after a spawn, and its close to the handler. Lock
order is one way only: the serving lock may take the router lock, never
the reverse; the router calls every handler callback with its own lock
released.
"""

from __future__ import annotations

import atexit
import hashlib
import itertools
import logging
import multiprocessing as mp
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from sparkdl_tpu_torch.cluster import aggregate, transport
from sparkdl_tpu_torch.cluster import worker as _worker_mod
from sparkdl_tpu_torch.core import durability, health, resilience, telemetry

logger = logging.getLogger(__name__)

# Flight-recorder bounds: how long a postmortem waits for on-demand
# span-ring pulls before bundling what it has, and how many bundles one
# router will write (a breach storm must not fill the disk).
_POSTMORTEM_RING_WAIT_S = 2.0
# How long a device-section pull waits: a worker answers between tasks.
_DEVICE_PULL_WAIT_S = 60.0
_POSTMORTEM_MAX = 8

# One spawn context for every router.
_MP_CTX = mp.get_context("spawn")

# Waiter/submitter poll granularity (bounds close/cancel detection
# latency) and worker join budget at close.
_WAIT_POLL_S = 0.05
_JOIN_TIMEOUT_S = 10.0
# Autoscaler thread tick, and the grace a draining worker gets to finish
# its in-flight tasks before it is torn down hard (DrainTimeout: its
# tasks then take the ordinary lost-worker re-dispatch path).
_AUTOSCALE_TICK_S = 0.25
_DRAIN_GRACE_S = 60.0

# Op chains whose tokens the router remembers (each entry holds its
# chain's ops, and so the weights they close over, alive).
_TOKEN_CACHE_CHAINS = 8

_run_ids = itertools.count(1)


def _build_before_spawn() -> float:
    """Build, in this process, every library a worker may load: the
    kernels when the engine runs on the card, and the native image
    loader on any device (a worker only loads; where the loader cannot
    build, it is unavailable here and in every worker alike). The
    seconds it took."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig
    from sparkdl_tpu_torch.native import loader

    t0 = time.perf_counter()
    if str(EngineConfig.device).startswith("cuda"):
        from sparkdl_tpu_torch.core import cuda_build

        cuda_build.build_all()
    loader.available()
    return time.perf_counter() - t0


def _tf32_flags() -> Optional[Tuple[bool, bool]]:
    """This process's ``(matmul, cudnn)`` TF32 switches, which a spawned
    worker would otherwise take from PyTorch's defaults: with them the
    workers' float32 products and convolutions round as this process's
    do. None when torch is not loaded here."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return None
    return (bool(torch.backends.cuda.matmul.allow_tf32),
            bool(torch.backends.cudnn.allow_tf32))


def _rebuild_error(type_name: str, msg: str, kind: str) -> BaseException:
    """Reconstruct a worker-side exception coordinator-side, preserving
    classification exactly: prefer the original type (builtin, then a
    ``resilience`` class) — but only if the rebuilt instance still
    classifies to the kind the worker computed; otherwise fall back to
    a RuntimeError carrying ``failure_kind``, the attribute
    ``resilience.classify`` trusts verbatim. Either way the
    coordinator's retry loop sees the kind an in-process attempt would
    have produced."""
    import builtins

    etype = getattr(builtins, type_name, None)
    if not (isinstance(etype, type) and issubclass(etype, Exception)):
        etype = getattr(resilience, type_name, None)
    if isinstance(etype, type) and issubclass(etype, Exception):
        try:
            err = etype(msg)
            if resilience.classify(err) == kind:
                return err
        except Exception:  # pragma: no cover - exotic ctor signature
            pass
    err = RuntimeError(f"{type_name}: {msg} (from cluster worker)")
    err.failure_kind = kind  # type: ignore[attr-defined]
    return err


class _Task:
    """One in-flight partition dispatch: the wire payload plus
    everything needed to re-dispatch it after a worker death."""

    __slots__ = ("task_id", "index", "token", "payload", "rows", "ctx",
                 "tenant", "event", "result", "error", "worker",
                 "redispatches")

    def __init__(self, index: int, token: str, payload: bytes,
                 rows: int, ctx=None, tenant: Optional[str] = None) -> None:
        self.task_id = 0
        self.index = index
        self.token = token
        self.payload = payload
        self.rows = rows
        # the job's tenant tag (EngineConfig.job_tenant): rides the task
        # message so worker-side executor metrics stay tenant-attributed
        self.tenant = tenant
        # the dispatch span's context, captured at submit: rides every
        # (re-)dispatch of this task so the worker-side span parents
        # under the SAME coordinator span a hedge/redispatch belongs to
        self.ctx = ctx
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.worker: Optional[int] = None
        self.redispatches = 0


class _Worker:
    """One worker process plus its PRIVATE task queue, its PRIVATE
    result pipe, the op-chain tokens already shipped to it, and its
    in-flight task ids / outstanding rows (the load signal)."""

    __slots__ = ("wid", "proc", "queue", "conn", "clock", "assigned",
                 "tokens", "outstanding_rows", "finished", "lost",
                 "draining", "drain_started", "drain_reason", "pilled",
                 "serving_assigned")

    def __init__(self, wid: int, proc: Any, queue: Any, conn: Any,
                 clock: Any) -> None:
        self.wid = wid
        self.proc = proc
        self.queue = queue
        self.conn = conn  # parent's read end; None once EOF-drained
        self.clock = clock  # clock-handshake pipe; None once answered
        self.assigned: Set[int] = set()
        # in-flight SERVING request ids (predicts and prepare acks), kept
        # apart from the partition tasks: a death hands exactly these to
        # the serving handler, and a draining worker is not pilled from
        # under an unanswered predict
        self.serving_assigned: Set[int] = set()
        self.tokens: Set[str] = set()
        self.outstanding_rows = 0
        self.finished = False  # final snapshot received
        self.lost = False      # died without a final snapshot
        # WorkerDraining state: no new dispatches; in-flight tasks run
        # to completion, then the router pills the worker, which ships
        # its final snapshot and exits cleanly (never a worker-lost
        # re-dispatch). Entered on a preemption notice (worker-side
        # SIGTERM-with-warning) or an autoscaler scale-down order.
        self.draining = False
        self.drain_started = 0.0
        self.drain_reason = ""
        self.pilled = False    # poison pill already sent


class ClusterRouter:
    """N spawn-context cluster workers behind a load-aware dispatch.

    ::

        router = ClusterRouter(workers=2)
        try:
            out = router.run_partition(i, batch, ops)
        finally:
            router.close()   # joins workers, merges their snapshots

    ``run_partition`` is thread-safe (concurrent partition tasks share
    the router and the ``cluster_inflight_partitions`` backpressure
    bound) and is a drop-in for ``dataframe._run_partition`` — callers
    normally never construct one; :func:`maybe_router` manages the
    process-wide instance from ``EngineConfig.cluster_workers``. The
    coordinator's run id (from the active telemetry scope, if any) is
    pinned into every worker's ``Telemetry(run_id=...)`` at spawn.
    """

    def __init__(self, workers: int, inflight: Optional[int] = None,
                 run_id: Optional[str] = None,
                 autoscale: Optional[bool] = None,
                 federation_s: Optional[float] = None,
                 federation_rules: Optional[Sequence[Any]] = None) -> None:
        if workers < 1:
            raise ValueError(
                f"cluster router needs >= 1 worker, got {workers}")
        self.workers = int(workers)
        self.inflight = int(inflight) if inflight else 2 * self.workers
        if self.inflight < 1:
            raise ValueError(
                f"cluster_inflight_partitions must be >= 1, got "
                f"{inflight!r}")
        tel = telemetry.active()
        self.run_id = run_id or (
            tel.run_id if tel is not None
            else f"cluster-{os.getpid():x}-{next(_run_ids):04x}")
        # workers must run with the coordinator's config — a spawned
        # interpreter starts from the defaults otherwise, and "cluster
        # on" must not change what runs
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        config = EngineConfig.snapshot()
        # a worker must never recurse into its own cluster, journal
        # coordinator-owned state, nest a decode pool per worker, or run
        # its own autoscaler (elasticity is coordinator-owned)
        config.update(cluster_workers=0, cluster_inflight_partitions=None,
                      decode_workers=0, decode_pool_inflight=None,
                      durable_dir=None, cluster_autoscale=False,
                      serving_cluster=False)

        # the coordinator's root span context ships in the boot blob:
        # worker-side ambient spans (compiles, executor launches) parent
        # under it instead of dangling off the worker's private root —
        # None (tracing off) keeps the worker's trace fully local
        self._boot_blob = transport.dumps(
            {"config": config,
             "tf32": _tf32_flags(),
             "root_ctx": tel.root_context if tel is not None else None,
             # exemplar reservoirs are per-registry opt-in: workers arm
             # the SAME k as the coordinator, or federated breach events
             # would lose their resolvable exemplar trace ids
             "exemplar_k": (tel.metrics.exemplar_k
                            if tel is not None else 0)})
        self._lock = threading.Lock()
        # the attached cluster serving handler (serving/cluster.py), or
        # None while the serving plane is off: srv_* replies, the exact
        # lost request ids of a dead worker, and replica top-ups after a
        # spawn go to it, always with this lock released
        self._serving: Optional[Any] = None
        self._pending: Dict[int, _Task] = {}
        self._ids = itertools.count(1)
        self._ops_blobs: Dict[str, bytes] = {}
        # (id(chain), base token) -> (the chain's ops, token). The entry
        # holds the ops themselves: a hit needs the very same op objects
        # (the base token reads no weights, and a freed chain's id is
        # reused), and holding them keeps their ids from being reused
        self._token_cache: Dict[Tuple[int, str],
                                Tuple[Tuple[Any, ...], str]] = {}
        self._finals: List[Dict[str, Any]] = []
        self._sem = threading.BoundedSemaphore(self.inflight)
        self._closed = False
        # -- elastic capacity --
        # Live worker indices keep growing past the initial range, so a
        # replacement never reuses a retired worker's name; the event
        # history is merged into the cluster report at close().
        self._autoscale = (bool(EngineConfig.cluster_autoscale)
                           if autoscale is None else bool(autoscale))
        self._next_index = self.workers
        self._last_scale_ts = float("-inf")
        self.autoscale_events: List[Dict[str, Any]] = []
        self._autoscale_stop = threading.Event()
        self._autoscale_thread: Optional[threading.Thread] = None
        # -- metrics federation, armed by
        # EngineConfig.cluster_federation_s:
        # workers ship windowed delta frames on that cadence; the
        # collector folds them into the ClusterMetricsView and drives
        # the federated SLO watchdog against the merged fold
        fed_s = (EngineConfig.cluster_federation_s
                 if federation_s is None else federation_s)
        self._fed_view: Optional[aggregate.ClusterMetricsView] = None
        self._fed_watchdog: Optional[Any] = None
        self._fed_breached: Set[str] = set()
        self._fed_fresh: Set[str] = set()
        if fed_s:
            from sparkdl_tpu_torch.core import slo as _slo

            self._fed_view = aggregate.ClusterMetricsView(float(fed_s))
            rules = (list(federation_rules)
                     if federation_rules is not None
                     else _default_federation_rules())
            self._fed_watchdog = _slo.SLOWatchdog(
                rules, attribution=self._fed_attribution)
        # flight recorder: breach/death/FATAL-triggered postmortem
        # bundles, written on short-lived daemon threads (the collector
        # must keep draining pipes — the bundle pulls span rings over
        # those same pipes, so writing in-collector would deadlock)
        self._pm_lock = threading.Lock()
        self._pm_seq = 0
        self._pm_threads: List[threading.Thread] = []
        self.postmortem_paths: List[str] = []
        self._ring_cond = threading.Condition()
        # (reply kind, worker index) -> a pulled ring or device section
        self._ring_box: Dict[Tuple[str, int], Dict[str, Any]] = {}
        # bench accounting: wall time inside dispatch vs worker-measured
        # op-chain time (their gap is the router's overhead)
        self.dispatch_s_total = 0.0
        #: partition results each worker delivered ("ok" messages), and
        #: results that found their task already resolved (a hedge's
        #: loser, an abandoned attempt): the router's count of how often
        #: a partition ran, which a worker that dies cannot report
        self.results: Dict[str, int] = {}
        self.late_results = 0
        #: (bytes, seconds) of each op chain pickled
        self.ops_pickles: List[Tuple[int, float]] = []
        self._payload_lock = threading.Lock()
        self.exec_s_total = 0.0
        self.worker_snapshots: List[Dict[str, Any]] = []
        self.cluster_report: Optional[Dict[str, Any]] = None
        self.run_report: Optional[Dict[str, Any]] = None
        # parent-internal wakeup pipe: nudges the collector out of its
        # connection.wait when the router closes
        self._wake_r, self._wake_w = _MP_CTX.Pipe(duplex=False)
        # every library is built HERE, before any worker exists: the
        # workers only load them
        self.build_s = _build_before_spawn()
        # incremental append (not a comprehension): a spawn failing at
        # worker k must leave workers 0..k-1 poisonable, not leaked
        self._workers: List[_Worker] = []
        try:
            for i in range(self.workers):
                self._workers.append(self._spawn(i))
        except BaseException:
            for worker in self._workers:
                worker.queue.put(None)
                worker.proc.join(timeout=_JOIN_TIMEOUT_S)
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
            target=self._collect, name="sparkdl-cluster-collector",
            daemon=True)
        self._collector.start()
        self._gauge_workers_locked_free()
        if self._autoscale:
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop,
                name="sparkdl-cluster-autoscaler", daemon=True)
            self._autoscale_thread.start()

    def _spawn(self, index: int) -> _Worker:
        queue = _MP_CTX.Queue()
        recv_conn, send_conn = _MP_CTX.Pipe(duplex=False)
        # dedicated duplex pipe for the one-shot clock handshake: the
        # collector answers the worker's ping with perf_counter_ns so
        # remote span timestamps land on the coordinator's timeline
        clock_parent, clock_child = _MP_CTX.Pipe()
        proc = _MP_CTX.Process(
            target=_worker_mod._worker_main,
            args=(index, queue, send_conn, os.getpid(), self.run_id,
                  self._boot_blob, clock_child, time.time()),
            name=f"sparkdl-cluster-{index}", daemon=True)
        proc.start()
        # drop the parent's copy of the write end: the worker owns the
        # only writer, so worker death shows up as EOF on recv_conn
        send_conn.close()
        clock_child.close()
        health.record(health.CLUSTER_WORKER_STARTED, worker=proc.name)
        return _Worker(index, proc, queue, recv_conn, clock_parent)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- the public partition entry point ------------------------------------

    def run_partition(self, index: int, batch: Any,
                      ops: Sequence[Any],
                      cancelled: Optional[threading.Event] = None) -> Any:
        """Drop-in for ``dataframe._run_partition``: the same supervisor
        retry loop, with the op chain executed on a cluster worker
        instead of this thread. Row/byte counting mirrors the inline
        path exactly (supervised attempts are counted once per winning
        attempt by the supervisor's resolve)."""
        from sparkdl_tpu_torch.engine import dataframe as _df
        from sparkdl_tpu_torch.engine import supervisor as _sup

        cfg = _df.EngineConfig
        chain = [self._remote_op(index, ops, cancelled)]
        out = _sup.run_partition_task(
            index, batch, chain, policy=_df._task_policy(),
            deadline_s=cfg.task_timeout_s,
            legacy_injector=cfg.fault_injector,
            max_fatal_attempts=(cfg.quarantine_max_fatal
                                if cfg.quarantine else 1),
            cancelled=cancelled)
        if cancelled is None and telemetry.active() is not None:
            telemetry.count(telemetry.M_ENGINE_ROWS_OUT, out.num_rows)
            telemetry.count(telemetry.M_ENGINE_BYTES_OUT, out.nbytes)
        return out

    def _remote_op(self, index: int, ops: Sequence[Any],
                   cancelled: Optional[threading.Event]):
        """The one-op chain handed to the supervisor: each invocation
        (first attempt, classified retry, hedge, quarantine confirm) is
        a FRESH dispatch — worker selection happens per attempt, which
        is exactly what gives retries-after-death and hedges their
        anti-affinity."""
        token = self._ops_payload(ops)

        def dispatch(batch: Any) -> Any:
            t0 = time.monotonic()
            with telemetry.span(telemetry.SPAN_CLUSTER_DISPATCH,
                                partition=index):
                task = self._submit(index, batch, token)
                out = self._await(task, cancelled)
            dt = time.monotonic() - t0
            with self._lock:
                self.dispatch_s_total += dt
            if telemetry.active() is not None:
                telemetry.observe(telemetry.M_CLUSTER_DISPATCH_S, dt)
            return out

        return dispatch

    def _ops_payload(self, ops: Sequence[Any]) -> str:
        """Ship-once op-chain registration. The token is
        ``durability.ops_token`` (the same canonicalization ``job_id``
        hashes — cluster transport and durable journals agree on chain
        identity) suffixed with the pickled payload's digest, so two
        chains the repr-canonicalization cannot distinguish still get
        distinct cache slots."""
        base = durability.ops_token(ops)
        key = (id(ops), base)

        def cached() -> Optional[str]:
            with self._lock:
                entry = self._token_cache.get(key)
            if entry is None or len(entry[0]) != len(ops) or any(
                    a is not b for a, b in zip(entry[0], ops)):
                return None
            return entry[1]

        token = cached()
        if token is not None:
            return token
        # one pickle a chain: the partitions of one job ask at once, and
        # a chain holding a model's weights takes a while to pickle
        with self._payload_lock:
            token = cached()
            if token is not None:
                return token
            t0 = time.perf_counter()
            blob = transport.dumps_ops(ops)
            token = f"{base}.{hashlib.sha256(blob).hexdigest()[:12]}"
            with self._lock:
                self.ops_pickles.append(
                    (len(blob), time.perf_counter() - t0))
                self._ops_blobs.setdefault(token, blob)
                if len(self._token_cache) >= _TOKEN_CACHE_CHAINS:
                    # the oldest chain goes (dicts keep insertion order)
                    del self._token_cache[next(iter(self._token_cache))]
                self._token_cache[key] = (tuple(ops), token)
        return token

    # -- submission / waiting ------------------------------------------------

    def _submit(self, index: int, batch: Any, token: str) -> _Task:
        payload = durability.encode_batch(batch)
        # bounded in-flight: backpressure here, with close detection so
        # a closed router cannot wedge a submitter forever
        while not self._sem.acquire(timeout=_WAIT_POLL_S):
            if self._closed:
                raise resilience.ClusterWorkerLost(
                    "cluster router closed while a dispatch was waiting "
                    "for an in-flight slot")
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        task = _Task(index, token, payload, batch.num_rows,
                     telemetry.current_context(),
                     tenant=EngineConfig.job_tenant)
        with self._lock:
            if self._closed:
                self._sem.release()
                raise resilience.ClusterWorkerLost(
                    "cluster router closed before the partition was "
                    "dispatched")
            task.task_id = next(self._ids)
            # hedge anti-affinity: a concurrent in-flight attempt of
            # the SAME partition must land on a different worker
            exclude = {t.worker for t in self._pending.values()
                       if t.index == index and t.worker is not None}
            self._pending[task.task_id] = task
            try:
                self._dispatch_locked(task, exclude)
            except BaseException:
                del self._pending[task.task_id]
                self._sem.release()
                raise
            total = self._outstanding_locked()
        self._gauge(total)
        return task

    def _dispatch_locked(self, task: _Task,
                         exclude: Set[Any] = frozenset()) -> None:
        """Hand a task to the least-loaded live worker (caller holds
        the lock). Load = outstanding rows (ties: in-flight task
        count). The armed ``cluster_worker_kill`` marker rides ON the
        task message, so the chosen worker dies holding exactly this
        partition — the precise re-dispatch path is what the injection
        exercises. Anti-affinity is best-effort: with every live worker
        excluded, landing somewhere beats failing the attempt."""
        live = [w for w in self._workers
                if not w.lost and not w.finished and not w.draining]
        candidates = [w for w in live if w.wid not in exclude] or live
        if not candidates:
            if any(w.draining and not w.lost and not w.finished
                   for w in self._workers):
                # every survivor is draining: the work itself is fine —
                # RETRYABLE, and a replacement/finished drain will take
                # the retry (never the worker-lost re-dispatch story)
                raise resilience.WorkerDraining(
                    f"every live cluster worker is draining; partition "
                    f"{task.index} must wait for a replacement")
            raise resilience.ClusterWorkerLost(
                f"no live cluster workers to run partition {task.index}")
        worker = min(candidates,
                     key=lambda w: (w.outstanding_rows, len(w.assigned)))
        if task.token not in worker.tokens:
            worker.queue.put(("ops", task.token,
                              self._ops_blobs[task.token]))
            worker.tokens.add(task.token)
        crash = resilience.should_fire("cluster_worker_kill",
                                       partition=task.index)
        # SIGTERM-with-warning (spot-VM preemption): the worker still
        # RUNS this task, then drains — zero re-execution by design
        preempt = resilience.should_fire("cluster_worker_preempt",
                                         partition=task.index)
        worker.queue.put(("task", task.task_id, task.index, task.token,
                          task.payload, crash, preempt, task.tenant,
                          task.ctx))
        worker.assigned.add(task.task_id)
        worker.outstanding_rows += task.rows
        task.worker = worker.wid

    def _await(self, task: _Task,
               cancelled: Optional[threading.Event]) -> Any:
        while not task.event.wait(_WAIT_POLL_S):
            if cancelled is not None and cancelled.is_set():
                # supervisor watchdog abandoned this attempt (deadline,
                # or a hedge already won): stop waiting; the worker's
                # late result resolves to an already-popped task and is
                # dropped by the collector
                self._abandon(task)
                raise resilience.ClusterWorkerLost(
                    f"partition {task.index} dispatch abandoned "
                    "(supervisor cancelled the attempt)")
        if task.error is not None:
            raise task.error
        return task.result

    def _abandon(self, task: _Task) -> None:
        with self._lock:
            if self._pending.pop(task.task_id, None) is None:
                return  # resolved concurrently; collector released
            self._discount_locked(task)
            total = self._outstanding_locked()
        self._sem.release()
        self._gauge(total)

    def _discount_locked(self, task: _Task) -> None:
        for worker in self._workers:
            if task.task_id in worker.assigned:
                worker.assigned.discard(task.task_id)
                worker.outstanding_rows = max(
                    0, worker.outstanding_rows - task.rows)

    def _outstanding_locked(self) -> int:
        return sum(w.outstanding_rows for w in self._workers)

    def _gauge(self, total: int) -> None:
        if telemetry.active() is not None:
            telemetry.gauge_set(telemetry.M_CLUSTER_OUTSTANDING_ROWS,
                                total)

    # -- the serving-plane transport (serving/cluster.py) --------------------

    def serving_attach(self, handler: Any) -> None:
        """Attach the cluster serving handler: ``srv_*`` worker replies
        (``on_message``), worker losses with the exact lost request ids
        (``on_worker_lost``), replica top-ups after a spawn
        (``on_worker_spawn``) and the router's close (``on_close``) go to
        it. One handler per router; attaching replaces the previous."""
        with self._lock:
            self._serving = handler

    def serving_live_workers(self) -> List[int]:
        """Worker ids that may take NEW serving dispatches: live and not
        draining (a draining worker finishes its in-flight predicts but
        admits none, as batch dispatch does)."""
        with self._lock:
            return [w.wid for w in self._workers
                    if not w.lost and not w.finished and not w.draining]

    def serving_worker_name(self, wid: int) -> str:
        with self._lock:
            worker = self._worker_by_wid_locked(wid)
            return (worker.proc.name if worker is not None
                    else f"sparkdl-cluster-{wid}")

    def serving_send(self, wid: int, msg: Tuple,
                     req_id: Optional[int] = None) -> None:
        """Put one serving-plane message on worker ``wid``'s private task
        queue (its replies come back over its result pipe as ``srv_*``
        messages, routed to the handler). ``req_id`` registers an
        expected reply under ``serving_assigned``: the worker's death
        then hands exactly this request to the handler, and a draining
        worker is pilled only once it has answered."""
        with self._lock:
            worker = self._worker_by_wid_locked(wid)
            if (worker is None or worker.lost or worker.finished
                    or self._closed):
                raise resilience.ServingReplicaLost(
                    f"cluster worker {wid} is gone (or the router is "
                    "closed); cannot dispatch the serving message")
            if worker.draining and req_id is not None:
                raise resilience.WorkerDraining(
                    f"cluster worker {wid} is draining; it admits no "
                    "new serving requests")
            try:
                worker.queue.put(msg)
            except ValueError:
                raise resilience.ServingReplicaLost(
                    f"cluster worker {wid}'s task queue is closed"
                ) from None
            if req_id is not None:
                worker.serving_assigned.add(req_id)

    def serving_done(self, wid: int, req_id: int) -> None:
        """Discount one answered (or abandoned) serving request from its
        worker; a draining worker whose partition AND serving in-flight
        sets just emptied is pilled here (the serving side of the drain
        hook in ``_on_message``)."""
        with self._lock:
            worker = self._worker_by_wid_locked(wid)
            if worker is None:
                return
            worker.serving_assigned.discard(req_id)
            if (worker.draining and not worker.assigned
                    and not worker.serving_assigned and not worker.pilled
                    and not self._closed):
                self._pill_locked(worker)

    def _worker_by_wid_locked(self, wid: int) -> Optional[_Worker]:
        for w in self._workers:
            if w.wid == wid:
                return w
        return None

    # -- the collector thread ------------------------------------------------

    def _collect(self) -> None:
        """Multiplex every worker's private result pipe. EOF on a pipe
        is the death (or clean-exit) signal; a dead worker's in-flight
        partitions are re-dispatched to survivors right here, so
        detection latency is one pipe wakeup, not a poll interval.
        Exits once the router is closed and every conn has EOF'd —
        which guarantees every final snapshot has been adopted."""
        from multiprocessing import connection as _mpc

        while True:
            with self._lock:
                conn_map = {w.conn: w for w in self._workers
                            if w.conn is not None}
                clock_map = {w.clock: w for w in self._workers
                             if w.clock is not None}
                done = self._closed and not conn_map and not clock_map
            if done:
                return
            for ready in _mpc.wait(list(conn_map) + list(clock_map)
                                   + [self._wake_r]):
                if ready is self._wake_r:
                    try:
                        self._wake_r.recv_bytes()
                    except (EOFError, OSError):  # pragma: no cover
                        pass
                    continue
                if ready in clock_map:
                    # one-shot clock handshake: answer the worker's ping
                    # with the coordinator's perf_counter_ns, then
                    # retire the pipe (EOF = the worker died first)
                    try:
                        ready.recv()
                        ready.send(time.perf_counter_ns())
                    except (EOFError, OSError):
                        pass
                    ready.close()
                    with self._lock:
                        clocked = clock_map[ready]
                        if clocked.clock is ready:
                            clocked.clock = None
                    continue
                worker = conn_map[ready]
                try:
                    msg = ready.recv()
                except (EOFError, OSError):
                    ready.close()
                    self._on_worker_eof(worker)
                    continue
                self._on_message(worker, msg)

    def _on_message(self, worker: _Worker, msg: Tuple) -> None:
        kind = msg[0]
        if isinstance(kind, str) and kind.startswith("srv_"):
            # a serving-plane reply: the handler resolves its waiter and
            # discounts it through serving_done (which pills a draining
            # worker once its serving in-flight set empties)
            handler = self._serving
            if handler is not None:
                handler.on_message(worker.wid, msg)
            return
        if kind == "frame":
            # windowed metrics delta frame (the federation cadence):
            # fold it, then judge the merged fold
            self._on_frame(worker, msg[2])
            return
        if kind in ("ring", "device"):
            # on-demand pull reply (a span ring, a device section):
            # route to the waiting thread
            with self._ring_cond:
                self._ring_box[(kind, worker.wid)] = msg[2]
                self._ring_cond.notify_all()
            return
        if kind == "final":
            with self._lock:
                worker.finished = True
                self._finals.append(msg[2])
            return
        if kind == "draining":
            # SIGTERM-with-warning reached the worker: stop dispatching
            # to it, let its in-flight tasks finish, pill it once empty
            # — a drain, never a ClusterWorkerLost re-dispatch storm
            self._begin_drain(worker, reason="preemption")
            return
        task_id = msg[1]
        with self._lock:
            task = self._pending.pop(task_id, None)
            if task is not None:
                self._discount_locked(task)
            total = self._outstanding_locked()
            if (worker.draining and not worker.assigned
                    and not worker.serving_assigned
                    and not worker.pilled and not self._closed):
                # last in-flight task just finished (and no serving
                # request awaits an answer): retire the worker (it ships
                # its final snapshot and EOFs cleanly)
                self._pill_locked(worker)
        with self._lock:
            if kind == "ok":
                self.results[worker.proc.name] = \
                    self.results.get(worker.proc.name, 0) + 1
            if task is None:
                self.late_results += 1
        if task is None:
            return  # re-dispatch duplicate or abandoned attempt
        if kind == "ok":
            _, _, payload, meta = msg
            task.result = durability.decode_batch(payload)
            with self._lock:
                self.exec_s_total += float(meta.get("exec_s", 0.0))
        else:
            _, _, type_name, message, err_kind = msg
            task.error = _rebuild_error(type_name, message, err_kind)
            if err_kind == resilience.FATAL:
                # a FATAL task failure is a flight-recorder trigger: the
                # postmortem captures the cluster state AT the failure,
                # not whatever remains at end of run
                self._trigger_postmortem(
                    "fatal_task",
                    {"partition": task.index, "worker": worker.proc.name,
                     "error": f"{type_name}: {message}"})
        task.event.set()
        self._sem.release()
        self._gauge(total)

    def _pill_locked(self, worker: _Worker) -> None:
        """Send the poison pill to one worker (caller holds the lock).
        Drain is PILL-driven: the worker never self-exits on SIGTERM, so
        a task sitting unread in its queue can never be stranded — the
        pill goes out only once ``assigned`` is empty."""
        try:
            worker.queue.put(None)
        except ValueError:  # pragma: no cover - queue reaped concurrently
            return
        worker.pilled = True

    def _begin_drain(self, worker: _Worker, reason: str) -> None:
        """Move one worker into the WorkerDraining state (idempotent).
        Dispatch stops immediately; the pill goes out as soon as the
        worker holds no in-flight tasks. A preemption drain that would
        leave the live set below the floor spawns a replacement."""
        spawned: Optional[_Worker] = None
        with self._lock:
            if (worker.draining or worker.lost or worker.finished
                    or self._closed):
                return
            worker.draining = True
            worker.drain_started = time.monotonic()
            worker.drain_reason = reason
            if (not worker.assigned and not worker.serving_assigned
                    and not worker.pilled):
                self._pill_locked(worker)
            if reason == "preemption":
                spawned = self._ensure_capacity_locked()
        health.record(health.CLUSTER_WORKER_DRAINING,
                      worker=worker.proc.name, reason=reason)
        if reason == "preemption":
            health.record(health.CLUSTER_PREEMPTION_NOTICE,
                          worker=worker.proc.name)
        self._note_autoscale_event("draining", worker=worker.proc.name,
                                   reason=reason)
        logger.warning("cluster worker %s draining (%s): %d in-flight "
                       "task(s) to finish", worker.proc.name, reason,
                       len(worker.assigned))
        if spawned is not None:
            self._after_spawn(spawned, reason="replace_preempted")

    def _ensure_capacity_locked(self) -> Optional[_Worker]:
        """Spawn a replacement when a preemption drain would leave the
        live set below the floor (caller holds the lock). Floor =
        ``cluster_min_workers`` with the autoscaler armed, else the
        configured worker count (static capacity must stay static)."""
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        floor = (EngineConfig.cluster_min_workers if self._autoscale
                 else self.workers)
        live = sum(1 for w in self._workers
                   if not w.lost and not w.finished and not w.draining)
        if live >= floor:
            return None
        spawned = self._spawn(self._next_index)
        # caller holds self._lock (the _locked-suffix contract)
        self._next_index += 1
        self._workers.append(spawned)
        return spawned

    def _after_spawn(self, worker: _Worker, reason: str) -> None:
        """Post-spawn bookkeeping done OUTSIDE the lock: wake the
        collector (it rebuilds its conn map per iteration, so the new
        worker's pipes join the multiplex on the next pass) and record
        the event."""
        try:
            self._wake_w.send_bytes(b"w")
        except (OSError, ValueError):  # pragma: no cover - closing
            pass
        self._gauge_workers_locked_free()
        self._note_autoscale_event("spawn", worker=worker.proc.name,
                                   reason=reason)
        handler = self._serving
        if handler is not None:
            # replica top-up: the deployments fan out to the new worker,
            # and the serving plane regains its replication factor
            handler.on_worker_spawn(worker.wid)

    def _gauge_workers_locked_free(self) -> None:
        if telemetry.active() is None:
            return
        with self._lock:
            live = sum(1 for w in self._workers
                       if not w.lost and not w.finished and not w.draining)
        telemetry.gauge_set(telemetry.M_CLUSTER_WORKERS, live)

    def _note_autoscale_event(self, action: str, **ctx: Any) -> None:
        with self._lock:
            self.autoscale_events.append(
                {"action": action, "t": time.monotonic(), **ctx})

    def _on_worker_eof(self, worker: _Worker) -> None:
        """A worker's pipe hit EOF. Clean exit (final already adopted,
        or the router is closing) just retires the conn; a DEATH marks
        the worker lost, abandons its queue, and re-dispatches exactly
        its in-flight task ids to survivors — one ``cluster_worker_lost``
        event per death, one ``cluster_redispatch`` per moved
        partition. No survivors: the partitions fail with a RETRYABLE
        ``ClusterWorkerLost`` and the supervisor's retry loop decides."""
        redispatched: List[_Task] = []
        failed: List[_Task] = []
        held: List[int] = []
        srv_lost: List[int] = []
        lost = False
        drained = False
        with self._lock:
            worker.conn = None
            if worker.draining and worker.finished:
                drained = True
            if not worker.finished and not self._closed:
                lost = True
                worker.lost = True
                # the exact serving loss set: the request ids awaiting an
                # answer from this worker, handed to the serving handler
                # (outside the lock) for re-admission within deadlines
                srv_lost = sorted(worker.serving_assigned)
                worker.serving_assigned.clear()
                # abandon the dead worker's queue WITHOUT joining its
                # feeder thread (it may be blocked writing to a pipe
                # nobody will ever read — the decode-pool lesson)
                worker.queue.cancel_join_thread()
                worker.queue.close()
                held = sorted(worker.assigned)
                worker.assigned.clear()
                worker.outstanding_rows = 0
                for task_id in held:
                    task = self._pending.get(task_id)
                    if task is None:
                        continue  # delivered just before dying
                    task.redispatches += 1
                    try:
                        self._dispatch_locked(task, exclude={worker.wid})
                        redispatched.append(task)
                    except resilience.ClusterWorkerLost as e:
                        del self._pending[task_id]
                        task.error = e
                        failed.append(task)
        if drained:
            drain_s = time.monotonic() - worker.drain_started
            logger.info("cluster worker %s drained cleanly in %.3fs (%s)",
                        worker.proc.name, drain_s, worker.drain_reason)
            health.record(health.CLUSTER_WORKER_DRAINED,
                          worker=worker.proc.name,
                          reason=worker.drain_reason,
                          drain_s=round(drain_s, 4))
            if telemetry.active() is not None:
                telemetry.observe(telemetry.M_CLUSTER_DRAIN_S, drain_s)
            self._note_autoscale_event("drained", worker=worker.proc.name,
                                       reason=worker.drain_reason,
                                       drain_s=round(drain_s, 4))
            self._gauge_workers_locked_free()
        if lost:
            logger.warning(
                "cluster worker %s died; re-dispatched %d in-flight "
                "partition(s) to survivors (%d unplaceable)",
                worker.proc.name, len(redispatched), len(failed))
            health.record(health.CLUSTER_WORKER_LOST,
                          worker=worker.proc.name, in_flight=len(held))
            view = self._fed_view
            if view is not None:
                # age the dead worker out of the federated fold NOW (no
                # more frames are coming) — its last shipped frame stays
                # retained for the postmortem bundle
                view.mark_dead(worker.proc.name)
                self._fed_fresh.discard(worker.proc.name)
                health.record(health.CLUSTER_METRICS_STALE,
                              worker=worker.proc.name,
                              reason="worker_lost")
                self._trigger_postmortem(
                    "worker_lost", {"worker": worker.proc.name})
            for task in redispatched:
                health.record(health.CLUSTER_REDISPATCH,
                              partition=task.index,
                              worker=worker.proc.name)
                if telemetry.active() is not None:
                    telemetry.count(telemetry.M_CLUSTER_REDISPATCH)
        for task in failed:
            task.event.set()
            self._sem.release()
        if lost:
            handler = self._serving
            if handler is not None:
                handler.on_worker_lost(worker.wid, srv_lost)

    # -- metrics federation + the flight recorder -----------------------------

    def _fed_attribution(self, rule: Any) -> Dict[str, Any]:
        """Per-worker observed values behind a federated breach (the
        SLOWatchdog attribution hook): which workers drove the merged
        verdict."""
        view = self._fed_view
        if view is None:
            return {}
        return view.attribution(rule.metric, rule.stat, rule.window_s)

    def _on_frame(self, worker: _Worker, frame: Dict[str, Any]) -> None:
        """Fold one worker's delta frame into the federated view, then
        evaluate the cluster SLO watchdog against the merged fold.
        Collector thread only — the watchdog's hold-down state is
        single-threaded by construction. A rule newly ENTERING breach
        trips the flight recorder (recoveries and still-breached rules
        do not: one bundle per incident, not per frame)."""
        view = self._fed_view
        if view is None:
            return
        view.ingest(frame)
        now = telemetry._monotonic()
        fresh = set(view.fresh_workers(now))
        for name in sorted(self._fed_fresh - fresh):
            # a worker stopped shipping frames without dying (wedged, or
            # a cadence stall): it silently left the fold — say so once
            health.record(health.CLUSTER_METRICS_STALE, worker=name,
                          reason="frames_stale")
        # collector-thread-only state (_on_frame and _on_worker_eof both run on the collector) — single writer by construction
        self._fed_fresh = fresh
        wd = self._fed_watchdog
        if wd is None:
            return
        verdicts = wd.evaluate(view, now=now)
        active = {name for name, v in verdicts.items() if v["breached"]}
        view.note_timeline({
            "t": now, "workers_reporting": len(fresh),
            "slo": {name: {"observed": v["observed"],
                           "breached": v["breached"]}
                    for name, v in verdicts.items()
                    if v["observed"] is not None or v["breached"]}})
        for name in sorted(active - self._fed_breached):
            self._trigger_postmortem(
                "slo_breach", {"rule": name, **verdicts[name]})
        # collector-thread-only state — single writer by construction
        self._fed_breached = active

    def _trigger_postmortem(self, trigger: str,
                            detail: Dict[str, Any]) -> None:
        """Arm one postmortem bundle write on a daemon thread. No
        federation, no active telemetry scope with an ``out_dir``,
        router closed, or the per-run bundle cap reached: no-op — the
        flight recorder never introduces artifacts (or blocking) into
        runs that didn't opt into observability."""
        if self._fed_view is None or self._closed:
            return
        tel = telemetry.active()
        out_dir = tel.out_dir if tel is not None else None
        if not out_dir:
            return
        with self._lock:
            if self._pm_seq >= _POSTMORTEM_MAX or self._closed:
                return
            self._pm_seq += 1
            seq = self._pm_seq
        recorder = threading.Thread(
            target=self._write_postmortem,
            args=(seq, trigger, dict(detail), out_dir),
            name=f"sparkdl-flight-recorder-{seq}", daemon=True)
        recorder.start()
        with self._lock:
            self._pm_threads.append(recorder)

    def _pull_rings(self) -> List[Dict[str, Any]]:
        """Fan an on-demand span-ring pull to every live worker and
        wait (bounded) for the replies. A worker that dies or stalls
        mid-pull just misses the bundle; the recorder ships what it
        has."""
        return list(self._pull("ring", _POSTMORTEM_RING_WAIT_S).values())

    def device_sections(self) -> Dict[str, Dict[str, Any]]:
        """Each live worker's ``device`` section as it stands now (kernel
        launches, forwards, captures, reserved memory), by worker name.
        Read before and after a pass, their difference is that pass's
        work. A worker that does not answer within the wait is missing
        from the result."""
        with self._lock:
            names = {w.wid: w.proc.name for w in self._workers}
        return {names[wid]: dev for wid, dev in
                self._pull("device", _DEVICE_PULL_WAIT_S).items()}

    def _pull(self, kind: str, wait_s: float) -> Dict[int, Dict[str, Any]]:
        """Send ``("pull_<kind>",)`` to every live worker and wait
        (bounded) for the replies, which the collector routes into the
        box as ``(kind, wid)``; by worker index, those that came."""
        with self._lock:
            if self._closed:
                return {}
            live = [w for w in self._workers
                    if not w.lost and not w.finished and not w.pilled]
            with self._ring_cond:
                for key in [k for k in self._ring_box if k[0] == kind]:
                    del self._ring_box[key]
            expect: Set[Tuple[str, int]] = set()
            for w in live:
                try:
                    w.queue.put((f"pull_{kind}",))
                    expect.add((kind, w.wid))
                except ValueError:  # queue reaped concurrently
                    pass
        deadline = time.monotonic() + wait_s
        with self._ring_cond:
            while not expect <= set(self._ring_box):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # the wait is deadline-bounded; a flight-recorder caller holds its own _pm_lock, which no hot path takes
                self._ring_cond.wait(remaining)
            return {wid: self._ring_box[(k, wid)] for k, wid in expect
                    if (k, wid) in self._ring_box}

    def _write_postmortem(self, seq: int, trigger: str,
                          detail: Dict[str, Any], out_dir: str) -> None:
        try:
            self._write_postmortem_inner(seq, trigger, detail, out_dir)
        # not a retry — the flight recorder is best-effort diagnostics and must never fail the run it is documenting
        except Exception:  # noqa: BLE001
            logger.exception("postmortem bundle %d failed; continuing",
                             seq)

    def _write_postmortem_inner(self, seq: int, trigger: str,
                                detail: Dict[str, Any],
                                out_dir: str) -> None:
        """One postmortem bundle: merged partial Chrome trace (live
        span-ring pulls), the last-K federated timeline, the health
        report, and the trigger's breach record — staged in a tmp dir
        and renamed into place, so ``postmortem_<run_id>_<seq>/`` is
        only ever observed complete."""
        import json

        # _pm_lock is the flight recorder's own serialization lock (only recorder threads ever take it) — holding it across the bounded ring wait is exactly its job; no hot path can contend
        with self._pm_lock:  # serialize pulls: the ring box is shared
            rings = self._pull_rings()
        view = self._fed_view
        tel = telemetry.active()
        bundle = f"postmortem_{self.run_id}_{seq:04d}"
        final_dir = os.path.join(out_dir, bundle)
        tmp_dir = final_dir + ".tmp"
        os.makedirs(tmp_dir, exist_ok=True)
        if tel is not None:
            trace = tel.tracer.merged_chrome_trace(rings)
            with open(os.path.join(tmp_dir, "trace.json"), "w",
                      encoding="utf-8") as f:
                json.dump(trace, f)
        if view is not None:
            with open(os.path.join(tmp_dir, "snapshots.jsonl"), "w",
                      encoding="utf-8") as f:
                for line in view.timeline():
                    f.write(json.dumps(line, default=repr) + "\n")
        mon = health.active_monitor()
        with open(os.path.join(tmp_dir, "health.json"), "w",
                  encoding="utf-8") as f:
            json.dump(mon.report() if mon is not None else None, f,
                      indent=2, default=repr)
        breach: Dict[str, Any] = {
            "trigger": trigger, "detail": detail,
            "run_id": self.run_id, "seq": seq,
            "rings_pulled": len(rings)}
        if view is not None:
            breach["federation"] = view.last_frames()
        with open(os.path.join(tmp_dir, "breach.json"), "w",
                  encoding="utf-8") as f:
            json.dump(breach, f, indent=2, default=repr)
        os.rename(tmp_dir, final_dir)
        with self._lock:
            self.postmortem_paths.append(final_dir)
        health.record(health.POSTMORTEM_DUMPED, trigger=trigger,
                      path=final_dir, seq=seq)
        logger.warning("flight recorder wrote postmortem bundle %s (%s)",
                       final_dir, trigger)

    # -- the autoscaler -------------------------------------------------------

    def _autoscale_loop(self) -> None:
        while not self._autoscale_stop.wait(_AUTOSCALE_TICK_S):
            if self._closed:
                return
            try:
                self.autoscale_tick()
            # not a retry — a failed advisory tick is logged and the next tick re-evaluates from fresh telemetry
            except Exception:  # noqa: BLE001 - a tick must never kill the loop
                logger.exception("autoscale tick failed; continuing")

    def autoscale_tick(self, now: Optional[float] = None) -> Optional[str]:
        """One autoscaling decision (deterministically testable; the
        background thread just calls this on a short tick). Signals:
        the windowed queue-wait p99 from the live telemetry scope and
        outstanding rows per live worker. Hysteresis = the wide gap
        between the high and low water marks; anti-flap = the cooldown
        since the last action, plus at most ONE drain in flight. Also
        enforces the drain grace: a worker stuck draining past
        ``_DRAIN_GRACE_S`` is torn down hard (DrainTimeout — its tasks
        take the ordinary lost-worker re-dispatch path). Returns
        ``"up"``, ``"down"``, or ``None``."""
        from sparkdl_tpu_torch.engine.dataframe import EngineConfig

        if not self._autoscale or self._closed:
            return None
        EngineConfig.validate()
        now = time.monotonic() if now is None else now
        p99: Optional[float] = None
        view = self._fed_view
        if view is not None:
            # federation armed: scale on the CLUSTER queue-wait p99 (the
            # merged-bucket fold over every reporting worker), not just
            # whatever the coordinator-local registry happened to see
            fed = view.window_snapshot(EngineConfig.autoscale_window_s)
            hist = fed["histograms"].get(telemetry.M_QUEUE_WAIT_S)
            p99 = hist.get("p99") if hist else None
        if p99 is None:
            tel = telemetry.active()
            if tel is not None:
                snap = tel.metrics.window_snapshot(
                    EngineConfig.autoscale_window_s)
                hist = snap["histograms"].get(telemetry.M_QUEUE_WAIT_S)
                p99 = hist.get("p99") if hist else None
        stuck: List[_Worker] = []
        with self._lock:
            if self._closed:
                return None
            live = [w for w in self._workers
                    if not w.lost and not w.finished and not w.draining]
            draining = [w for w in self._workers
                        if w.draining and not w.lost and not w.finished]
            for w in draining:
                if now - w.drain_started > _DRAIN_GRACE_S:
                    stuck.append(w)
            n_live = len(live)
            outstanding = sum(w.outstanding_rows for w in live)
            idle = [w for w in live
                    if not w.assigned and not w.outstanding_rows]
        for w in stuck:
            logger.warning(
                "cluster worker %s exceeded the %.0fs drain grace; "
                "terminating (DrainTimeout — in-flight tasks will "
                "re-dispatch)", w.proc.name, _DRAIN_GRACE_S)
            self._note_autoscale_event("drain_timeout",
                                       worker=w.proc.name,
                                       error="DrainTimeout")
            w.proc.terminate()  # EOF reap marks it lost + re-dispatches
        if now - self._last_scale_ts < EngineConfig.autoscale_cooldown_s:
            return None
        rows_per = (outstanding / n_live) if n_live else float("inf")
        hot = ((p99 is not None
                and p99 > EngineConfig.autoscale_queue_wait_high_s)
               or rows_per > EngineConfig.autoscale_rows_per_worker_high)
        cold = (p99 is None
                or p99 < EngineConfig.autoscale_queue_wait_low_s)
        if hot and n_live < EngineConfig.cluster_max_workers:
            with self._lock:
                if self._closed:
                    return None
                spawned = self._spawn(self._next_index)
                self._next_index += 1
                self._workers.append(spawned)
                self._last_scale_ts = now
            health.record(health.CLUSTER_SCALE_UP,
                          worker=spawned.proc.name, workers=n_live + 1,
                          queue_wait_p99_s=p99,
                          rows_per_worker=round(rows_per, 1))
            logger.warning(
                "cluster autoscaler scaling UP to %d worker(s) "
                "(queue-wait p99 %s, %.0f rows/worker)", n_live + 1,
                f"{p99:.4f}s" if p99 is not None else "n/a", rows_per)
            self._after_spawn(spawned, reason="scale_up")
            return "up"
        if (cold and not draining and idle
                and n_live > EngineConfig.cluster_min_workers):
            # retire the newest idle worker: drain is instant (nothing
            # in flight), so the pill goes out right away
            victim = max(idle, key=lambda w: w.wid)
            with self._lock:
                self._last_scale_ts = now
            health.record(health.CLUSTER_SCALE_DOWN,
                          worker=victim.proc.name, workers=n_live - 1,
                          queue_wait_p99_s=p99)
            logger.info(
                "cluster autoscaler scaling DOWN to %d worker(s) "
                "(queue-wait p99 %s; retiring idle %s)", n_live - 1,
                f"{p99:.4f}s" if p99 is not None else "n/a",
                victim.proc.name)
            self._begin_drain(victim, reason="scale_down")
            self._gauge_workers_locked_free()
            return "down"
        return None

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Poison, join, and reap every worker; drain every pipe to EOF
        (adopting the final snapshots); merge the snapshots into
        :attr:`cluster_report` / :attr:`run_report`. Idempotent; safe
        mid-stream (waiters fail with a RETRYABLE ClusterWorkerLost
        rather than hanging)."""
        self._autoscale_stop.set()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            abandoned = list(self._pending.values())
            self._pending.clear()
            for worker in self._workers:
                worker.assigned.clear()
                worker.outstanding_rows = 0
            workers = list(self._workers)
        for worker in workers:
            try:
                worker.queue.put(None)  # poison pill per private queue
            except ValueError:  # queue closed by a concurrent EOF reap
                pass
        for worker in workers:
            worker.proc.join(timeout=_JOIN_TIMEOUT_S)
            if worker.proc.is_alive():  # pragma: no cover - wedged worker
                worker.proc.terminate()
                worker.proc.join(timeout=_JOIN_TIMEOUT_S)
            # a dead worker never consumed its pill; don't let the
            # queue's feeder thread block interpreter exit on it
            worker.queue.cancel_join_thread()
            worker.queue.close()
        # the joins closed every write end: the collector drains each
        # conn to EOF — adopting every final snapshot — then sees
        # closed + no live conns and exits; the wake byte covers it
        # being parked on an empty list
        self._wake_w.send_bytes(b"c")
        self._collector.join(timeout=_JOIN_TIMEOUT_S)
        if self._collector.is_alive():  # pragma: no cover - a wedged pipe
            logger.error("cluster collector did not drain its pipes in "
                         "%.0fs; merging the snapshots it adopted",
                         _JOIN_TIMEOUT_S)
        if self._autoscale_thread is not None:
            self._autoscale_thread.join(timeout=_JOIN_TIMEOUT_S)
        with self._lock:
            recorders = list(self._pm_threads)
        for recorder in recorders:
            # in-flight postmortem bundles finish (their ring waits are
            # bounded) before the reports merge — a bundle must land
            # BEFORE the run ends, never race interpreter teardown
            recorder.join(timeout=_JOIN_TIMEOUT_S)
        for task in abandoned:
            task.error = resilience.ClusterWorkerLost(
                "cluster router closed mid-stream")
            task.event.set()
            self._sem.release()
        handler = self._serving
        if handler is not None:
            # serving requests still unanswered now are orphans (their
            # worker exited without replying): fail them classified
            # rather than let a waiter spin to its deadline
            handler.on_close()
        self._wake_w.close()
        self._wake_r.close()
        with self._lock:
            finals = list(self._finals)
        self.worker_snapshots = finals
        lost = [w.proc.name for w in workers if w.lost]
        tel = telemetry.active()
        if tel is not None:
            # merge the worker span rings into the coordinator's tracer
            # BEFORE building the reports, so the Chrome trace and the
            # trace summary both see every adopted span
            for snap in finals:
                ring = snap.get("span_ring")
                if ring is not None:
                    tel.tracer.adopt_remote_spans(ring["spans"])
        with self._lock:
            scale_events = list(self.autoscale_events)
        self.cluster_report = aggregate.merge_snapshots(
            finals, lost_workers=lost, autoscale_events=scale_events)
        with self._lock:
            self.cluster_report["results"] = {
                "per_worker": dict(sorted(self.results.items())),
                "late": self.late_results, "build_s": self.build_s,
                "dispatch_s": round(self.dispatch_s_total, 6),
                "exec_s": round(self.exec_s_total, 6),
                "ops_pickles": list(self.ops_pickles)}
        self.run_report = (
            aggregate.merged_run_report(tel, finals, lost_workers=lost,
                                        autoscale_events=scale_events)
            if tel is not None else None)
        view = self._fed_view
        if view is not None:
            fed_sec = view.status()
            with self._lock:
                fed_sec["postmortems"] = list(self.postmortem_paths)
            self.cluster_report["federation"] = fed_sec
            if self.run_report is not None:
                self.run_report.setdefault(
                    "cluster", {})["federation"] = fed_sec
        if handler is not None:
            # the coordinator's half of the serving plane (replica map,
            # failovers, cutovers) joins the workers' serving stats that
            # the snapshot merge folded: one `serving` section per report
            srv = handler.report_section()
            self.cluster_report.setdefault("serving", {})["router"] = srv
            if self.run_report is not None:
                cluster_sec = self.run_report.setdefault("cluster", {})
                cluster_sec.setdefault("serving", {})["router"] = srv
                self.run_report["serving"] = cluster_sec["serving"]

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:  # safety net only; callers use close()/with
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# ---------------------------------------------------------------------------
# The process-wide router (EngineConfig.cluster_workers is the ONE knob)
# ---------------------------------------------------------------------------

_router_lock = threading.Lock()
_router: Optional[ClusterRouter] = None
_router_key: Optional[Tuple[int, Optional[int], bool,
                            Optional[float]]] = None
_last_router: Optional[ClusterRouter] = None


def _default_federation_rules() -> List[Any]:
    """The ruleset a router's federated watchdog runs when the caller
    supplied none: the ``cluster_``-prefixed copies of
    ``slo.default_rules``. Module-level so tests (and operators with a
    sitecustomize) can swap the default in ONE place."""
    from sparkdl_tpu_torch.core import slo as _slo

    return list(_slo.federated_default_rules())


def exporter_status() -> Optional[Dict[str, Any]]:
    """Compact federated-view status for the snapshot exporter's
    ``cluster`` key — ``None`` unless a LIVE router has federation
    armed. The exporter probes this via ``sys.modules`` (it never
    imports the cluster plane), so a run that never armed it emits
    byte-identical artifacts."""
    router = _router
    if router is None or router.closed:
        return None
    view = router._fed_view
    if view is None:
        return None
    status = view.status()
    with router._lock:
        if router.postmortem_paths:
            status["postmortems"] = list(router.postmortem_paths)
    return status


def exporter_prometheus_text() -> str:
    """Federated ``sparkdl_cluster_*`` Prometheus families for the
    exporter's ``.prom`` file — ``""`` unless a live router has
    federation armed, so the off-path scrape text is unchanged."""
    router = _router
    if router is None or router.closed:
        return ""
    view = router._fed_view
    if view is None:
        return ""
    return view.prometheus_text()


def maybe_router() -> Optional[ClusterRouter]:
    """The process-wide router per ``EngineConfig.cluster_workers``, or
    ``None`` when the cluster plane is disabled (``cluster_workers=0``,
    the bit-identical in-process default) or when called from inside a
    cluster worker. Reconfiguring the knobs closes the old router (and
    merges its reports) before spawning the new one."""
    if _worker_mod._IN_WORKER:
        return None
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    EngineConfig.validate()
    workers = EngineConfig.cluster_workers
    if not workers:
        return None
    key = (workers, EngineConfig.cluster_inflight_partitions,
           EngineConfig.cluster_autoscale,
           EngineConfig.cluster_federation_s)
    global _router, _router_key, _last_router
    with _router_lock:
        stale = _router
        if stale is not None and _router_key == key and not stale.closed:
            return stale
        _router = None
    if stale is not None:
        stale.close()  # outside the lock: close() joins processes
        _last_router = stale
    with _router_lock:
        if _router is None or _router_key != key or _router.closed:
            _router = ClusterRouter(
                workers, inflight=EngineConfig.cluster_inflight_partitions)
            _router_key = key
        return _router


def shutdown() -> None:
    """Close the process-wide router (tests, bench legs, atexit) —
    this is the moment workers ship their snapshots and the merged
    reports land (readable via :func:`last_cluster_report`)."""
    global _router, _last_router
    with _router_lock:
        router, _router = _router, None
    if router is not None:
        router.close()
        _last_router = router


def last_cluster_report() -> Optional[Dict[str, Any]]:
    """The most recent merged per-worker snapshot section (survives
    :func:`shutdown` — reports are produced BY closing)."""
    router = _router if _router is not None else _last_router
    return router.cluster_report if router is not None else None


def last_run_report() -> Optional[Dict[str, Any]]:
    """The most recent merged ``RunReport`` (coordinator report + the
    ``cluster`` section), if a telemetry scope was active at close."""
    router = _router if _router is not None else _last_router
    return router.run_report if router is not None else None


atexit.register(shutdown)
