"""The port's DataFrame engine and its configuration.

A port of the parts of ``sparkdl_tpu.engine.dataframe`` that the
featurize path and the flagship workflow use (the SQL surface:
``where``, ``selectExpr``, temp views, ``sql`` and ``table``; and
``filter``, ``dropna``, ``limit``, ``randomSplit`` and the column
renames). A frame is a list of partitions, each a
:class:`Batch` of plain columns — numpy arrays (dim 0 = rows), Python
lists, or :class:`~sparkdl_tpu_torch.image.imageIO.ImageColumn` — plus a
lazy chain of per-partition ops.

Materializing a frame runs each partition's op chain as one supervised
task (``engine/supervisor.py``) on a shared thread pool
(``EngineConfig.max_workers`` threads named ``sparkdl-part-*``): the
classified task retry, the deadline watchdog, hedging of stragglers and
quarantine are the reference's, with its knobs. Each task enters the
card through ``core.executor.execute``, where concurrent partitions of
one model coalesce into one launch. A materialization started from a
partition thread runs inline, as in the reference, since waiting on the
pool from one of its own threads could deadlock. ``streamPartitions``
yields the partitions one at a time from the same pool, with at most
``prefetch + 1`` started and not yet yielded (the supervisor's streaming
mode).
With ``EngineConfig.durable_dir`` set, a materialization or stream is a
durable job (``core/durability.py``): each finished partition is spilled
and journaled, and a rerun of the same plan after a crash loads the
committed partitions and computes only the rest. With
``EngineConfig.cluster_workers`` set, the supervised paths run each
partition's op chain on one of that many spawned worker processes
(``cluster/router.py``) instead of a thread of this process; the journal
wraps outside the router. ``join``, ``groupBy``, ``orderBy``, ``union``,
``distinct`` and ``sample`` are not ported yet.
"""

from __future__ import annotations

import concurrent.futures as _futures
import os
import threading
from typing import (
    Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np

from sparkdl_tpu_torch.core import resilience, telemetry
from sparkdl_tpu_torch.engine import supervisor as _sup
from sparkdl_tpu_torch.image.imageIO import (
    ImageColumn, imageFields, imageStructsToColumn,
)


class EngineConfig:
    """Engine-wide knobs (class attributes), the reference's names,
    defaults and validation for every knob the port has."""

    # -- task retry (engine/supervisor.run_partition_task) -------------------
    max_task_retries: int = 2
    # Backoff between retryable attempts; 0 retries immediately.
    # task_retry_policy overrides both.
    task_retry_delay_s: float = 0.0
    task_retry_policy: Optional[resilience.RetryPolicy] = None
    # -- deadline watchdog ----------------------------------------------------
    # Per-task wall-clock budget (seconds); None disables. Enforced
    # cooperatively inside the task and preemptively by the supervisor's
    # watchdog, so a hung op fails the task instead of wedging the run.
    task_timeout_s: Optional[float] = None
    # -- speculative execution (straggler hedging) ----------------------------
    # Off by default: hedging re-runs ops, which must be pure.
    speculation: bool = False
    speculation_quantile: float = 0.75
    speculation_multiplier: float = 1.5
    speculation_min_runtime_s: float = 0.05
    # -- quarantine (opt-in skip-and-degrade) ---------------------------------
    # Drop a partition that fails FATALLY (after quarantine_max_fatal
    # classified-fatal attempts) instead of failing the job: a zero-row
    # batch with the op chain's output columns stands in, and the drop is
    # recorded in the active HealthMonitor.
    quarantine: bool = False
    quarantine_max_fatal: int = 1
    # -- cross-partition coalescing (core/executor.py) ------------------------
    # Concurrent partition tasks submitting small chunks against the same
    # compiled program coalesce into one padded bucket launch (one graph
    # replay). A solo request under no contention takes the inline path.
    coalesce: bool = True
    # Bounded wait (milliseconds) for sibling requests before launching;
    # None = adaptive (a fraction of the observed request latency).
    coalesce_window_ms: Optional[float] = None
    # Row cap of one coalesced launch; None = the request's batch_size.
    coalesce_max_rows: Optional[int] = None
    # -- executor overload protection (core/executor.py) ----------------------
    # Admission control: per-program bounds on queued requests / rows.
    # None (default) = unbounded.
    executor_max_queued_requests: Optional[int] = None
    executor_max_queued_rows: Optional[int] = None
    # Over the bound: "block" (default) waits with backpressure, bounded
    # by the caller's task deadline; "shed" fails fast with
    # ExecutorOverloaded (RETRYABLE — the task retry absorbs the spike).
    executor_overload_mode: str = "block"
    # Priority lane of requests that don't say: "interactive" drains
    # first and sheds last, "bulk" (default) the other way round.
    executor_default_priority: str = "bulk"
    # Per-model circuit breaker: open after this many terminal launch
    # failures within executor_breaker_window_s, fail fast for
    # executor_breaker_cooldown_s, then admit one half-open probe. 0
    # (default) disables it.
    executor_breaker_threshold: int = 0
    executor_breaker_window_s: float = 30.0
    executor_breaker_cooldown_s: float = 1.0
    # A model's coalescing state (and its coalescer thread) is dropped
    # after this many idle seconds.
    executor_idle_retire_s: float = 5.0
    # -- per-tenant fair queueing (core/executor.py) --------------------------
    # Relative deficit-round-robin weights per tenant tag; absent tenants
    # (and all tenants when None) weigh 1.
    executor_tenant_weights: Optional[Dict[str, int]] = None
    # Tenant tag of requests that carry none (explicit execute(tenant=)
    # > ambient executor.tenant_scope > this).
    executor_default_tenant: str = "default"
    # Threads of the shared partition pool.
    max_workers: int = max(2, (os.cpu_count() or 4) // 2)
    # Compat hook: callable(partition_index, attempt) that may raise to
    # simulate a task failure; new code arms the resilience.FaultInjector
    # "engine_task" / "task_stall" points.
    fault_injector: Optional[Callable[[int, int], None]] = None
    # -- parallel host decode (core/decode_pool.py) ---------------------------
    # Worker processes of the decode pool. 0 (the default) decodes inline,
    # bit-identical; N > 0 shares one process-wide pool of N spawned
    # workers across the ingest paths (readImages, loadImagesInternal).
    decode_workers: int = 0
    # Max decode chunks in flight pool-wide (bounds the host memory held
    # by decoded, unconsumed pixels); None = 2 * decode_workers.
    decode_pool_inflight: Optional[int] = None

    # Precision the executor applies to every model
    # (ModelFunction.with_dtype): "bfloat16" (the default), "float32" or
    # "int8" (weight-only post-training quantization, bf16 compute).
    inference_precision: str = "bfloat16"
    # Ship raw uint8 at source size and resize on the device
    # (ModelFunction.resized, the preproc_resize kernel). False resizes a
    # downscale on the host (the native loader's sdl_resize_batch, numpy
    # without it) and ships the smaller batch; an upscale still resizes
    # on the device.
    fused_preprocess: bool = True
    # Where models run. "cuda" is the default; without a card, transform
    # raises rather than silently running on the CPU. Tests set "cpu".
    device: str = "cuda"
    # The kernel gate (core/kernels.py), the JAX package's knob and values.
    # "autotune" (the default): a hand-written kernel runs at a site
    # (kernel, model family, shape, dtype) only after it beat its library
    # twin there by >= 5% within the numeric contract (float32 bit for
    # bit, bf16 <= 0.05); sites are auditioned on the card at the first
    # sight of each input shape, and the verdicts persist in
    # $SPARKDL_COMPILE_CACHE_DIR. "force": every feasible site runs its
    # kernel, no audition. "off": no kernel runs, nothing is auditioned.
    pallas_kernels: str = "autotune"
    # Tail-bucket ladder: "tuned" (default) arms the per-model
    # telemetry-tuned BucketPlanner (core/batching.py) — identical to the
    # blind ladder until enough launches are observed, then rungs move to
    # the observed size distribution (each new rung is one more captured
    # graph); "pow2" keeps the blind power-of-two ladder everywhere.
    bucket_ladder: str = "tuned"
    # -- the serving plane (serving/) -----------------------------------------
    # Capture a deployment's whole bucket ladder (one dummy batch per rung
    # through the executor, which also settles the kernel gate's
    # verdicts) when it is deployed and at every cold load, so its first
    # request captures nothing. False (default): the first request of
    # each rung captures.
    serving_warmup: bool = False
    # Route ModelServer.predict through the cluster serving router
    # (serving/cluster.py): deployments replicate across the cluster
    # workers, requests route with load and locality awareness, a worker's
    # death re-admits its in-flight predicts on survivors within the
    # caller's deadline, and cutover is cluster-atomic and two-phase.
    # Needs cluster_workers > 0; False (default) keeps the single-process
    # serving path, and serving/cluster.py is never imported. Always
    # forced off inside a worker (a replica must not recurse).
    serving_cluster: bool = False
    # Per-worker card residency budget of the replicated deployments; None
    # gives each worker's registry an unbudgeted cache (a model stays
    # resident until retired).
    serving_worker_residency_bytes: Optional[int] = None
    # How many times one in-flight predict may be re-admitted after
    # replica deaths before it fails with ServingReplicaLost (the
    # caller's deadline bounds it anyway; this bounds rolling-death
    # churn).
    serving_failover_max: int = 2
    # -- durable job recovery (core/durability.py) ----------------------------
    # Root directory of the write-ahead partition journals and their
    # spills. None (the default): no durability, and nothing of the
    # journal is imported or opened. Set, each materialize and
    # streamPartitions job derives a stable job id under this root and
    # survives kill -9: on restart the committed partitions load from
    # their verified spills, only the others run, and rows come back in
    # their order.
    durable_dir: Optional[str] = None
    # -- the cluster inference plane (cluster/) -------------------------------
    # Spawned worker PROCESSES, each with a whole inference stack of its
    # own (its CUDA context, DeviceExecutor and captured graphs, telemetry
    # pinned to the coordinator's run id); supervised materialize and
    # stream partitions go to the least-loaded worker, with the retry,
    # hedging, quarantine and deadlines kept in this process. 0 (the
    # default) keeps the in-process path, and the cluster package is
    # never imported.
    cluster_workers: int = 0
    # Dispatches in flight router-wide (bounds the coordinator's memory
    # for shipped, unconsumed partitions); None = 2 * cluster_workers.
    cluster_inflight_partitions: Optional[int] = None
    # -- elastic capacity (the router's autoscaler and graceful drain) -------
    # Grow and shrink the live worker set between cluster_min_workers and
    # cluster_max_workers from the windowed queue-wait p99 and the rows in
    # flight per worker. False (the default) keeps exactly
    # cluster_workers. Always off inside workers.
    cluster_autoscale: bool = False
    cluster_min_workers: int = 1
    cluster_max_workers: int = 8
    # The telemetry window the scaling signals are read over, and the
    # least quiet time between two scaling actions.
    autoscale_window_s: float = 5.0
    autoscale_cooldown_s: float = 5.0
    # Scale up when the windowed queue-wait p99 passes the high mark (or
    # rows in flight per worker pass theirs); scale down only when the
    # p99 is under the much lower low mark and a worker is idle.
    autoscale_queue_wait_high_s: float = 0.5
    autoscale_queue_wait_low_s: float = 0.05
    autoscale_rows_per_worker_high: int = 4096
    # -- live metrics federation (cluster/aggregate.ClusterMetricsView) ------
    # Seconds between the windowed-metrics frames each worker ships; the
    # coordinator folds them into one live view (merged percentiles,
    # summed rates) that the federated SLO watchdog, the autoscaler and
    # the exporter read. None (the default): no frames, no view. Not
    # forced off inside workers: their loop reads it for its cadence.
    cluster_federation_s: Optional[float] = None
    # The tenant tag of this job's partition dispatches through the
    # cluster router (an executor.tenant_scope around each task in its
    # worker); None leaves partition work on the default tenant.
    job_tenant: Optional[str] = None

    _PRECISIONS = ("float32", "bfloat16", "int8")
    _KERNEL_MODES = ("off", "autotune", "force")
    _LADDERS = ("tuned", "pow2")

    @classmethod
    def snapshot(cls) -> Dict[str, Any]:
        """Every public knob's current value — the one save/restore idiom
        for code that mutates the class-wide config (a new knob is
        covered without listing it). A callable knob value (a set
        ``fault_injector``) is left out, as in the reference."""
        return {k: getattr(cls, k) for k in vars(cls)
                if not k.startswith("_") and not callable(getattr(cls, k))}

    @classmethod
    def restore(cls, saved: Dict[str, Any]) -> None:
        """Reapply a :meth:`snapshot`."""
        for k, v in saved.items():
            setattr(cls, k, v)

    @classmethod
    def validate(cls) -> None:
        """Validate every knob at READ time with a clear ``ValueError``
        (instead of undefined downstream behavior: a negative timeout
        expiring every task, a zero queue cap wedging admission). Called
        per materialization and per device entry."""

        def positive(name, value, allow_none=True, minimum=0.0,
                     exclusive=True):
            if value is None:
                if not allow_none:
                    raise ValueError(f"EngineConfig.{name} must be set")
                return
            bad = value <= minimum if exclusive else value < minimum
            if bad:
                op = ">" if exclusive else ">="
                raise ValueError(
                    f"EngineConfig.{name} must be {op} {minimum} (or "
                    f"None), got {value!r}")

        if cls.max_task_retries < 0:
            raise ValueError("EngineConfig.max_task_retries must be >= 0, "
                             f"got {cls.max_task_retries!r}")
        positive("task_retry_delay_s", cls.task_retry_delay_s,
                 exclusive=False)
        positive("task_timeout_s", cls.task_timeout_s)
        if not 0.0 <= cls.speculation_quantile <= 1.0:
            raise ValueError(
                "EngineConfig.speculation_quantile must be in [0, 1], "
                f"got {cls.speculation_quantile!r}")
        positive("speculation_multiplier", cls.speculation_multiplier)
        positive("speculation_min_runtime_s", cls.speculation_min_runtime_s,
                 exclusive=False)
        if cls.quarantine_max_fatal < 1:
            raise ValueError(
                "EngineConfig.quarantine_max_fatal must be >= 1, got "
                f"{cls.quarantine_max_fatal!r}")
        positive("coalesce_window_ms", cls.coalesce_window_ms,
                 exclusive=False)
        positive("coalesce_max_rows", cls.coalesce_max_rows)
        positive("executor_max_queued_requests",
                 cls.executor_max_queued_requests)
        positive("executor_max_queued_rows", cls.executor_max_queued_rows)
        if cls.executor_overload_mode not in ("block", "shed"):
            raise ValueError(
                "EngineConfig.executor_overload_mode must be 'block' or "
                f"'shed', got {cls.executor_overload_mode!r}")
        if cls.executor_default_priority not in ("interactive", "bulk"):
            raise ValueError(
                "EngineConfig.executor_default_priority must be "
                "'interactive' or 'bulk', got "
                f"{cls.executor_default_priority!r}")
        if cls.executor_breaker_threshold < 0:
            raise ValueError(
                "EngineConfig.executor_breaker_threshold must be >= 0 "
                f"(0 disables), got {cls.executor_breaker_threshold!r}")
        positive("executor_breaker_window_s", cls.executor_breaker_window_s)
        positive("executor_breaker_cooldown_s",
                 cls.executor_breaker_cooldown_s, exclusive=False)
        positive("executor_idle_retire_s", cls.executor_idle_retire_s,
                 allow_none=False)
        if cls.executor_tenant_weights is not None:
            if not isinstance(cls.executor_tenant_weights, dict):
                raise ValueError(
                    "EngineConfig.executor_tenant_weights must be None "
                    "or a dict of tenant -> positive int weight, got "
                    f"{cls.executor_tenant_weights!r}")
            for t, w in cls.executor_tenant_weights.items():
                if not isinstance(t, str) or not t:
                    raise ValueError(
                        "EngineConfig.executor_tenant_weights keys must "
                        f"be non-empty tenant strings, got {t!r}")
                if not isinstance(w, int) or isinstance(w, bool) or w < 1:
                    raise ValueError(
                        "EngineConfig.executor_tenant_weights values "
                        f"must be positive ints, got {t!r}={w!r}")
        if (not isinstance(cls.executor_default_tenant, str)
                or not cls.executor_default_tenant):
            raise ValueError(
                "EngineConfig.executor_default_tenant must be a "
                f"non-empty string, got {cls.executor_default_tenant!r}")
        if cls.max_workers < 1:
            raise ValueError("EngineConfig.max_workers must be >= 1, got "
                             f"{cls.max_workers!r}")
        if cls.decode_workers < 0:
            raise ValueError(
                "EngineConfig.decode_workers must be >= 0 (0 disables "
                f"the decode pool), got {cls.decode_workers!r}")
        positive("decode_pool_inflight", cls.decode_pool_inflight)
        if not isinstance(cls.fused_preprocess, bool):
            raise ValueError(
                "EngineConfig.fused_preprocess must be a bool, got "
                f"{cls.fused_preprocess!r}")
        if cls.inference_precision not in cls._PRECISIONS:
            raise ValueError(
                f"EngineConfig.inference_precision must be one of "
                f"{cls._PRECISIONS}, got {cls.inference_precision!r}")
        if cls.pallas_kernels not in cls._KERNEL_MODES:
            raise ValueError(
                f"EngineConfig.pallas_kernels must be one of "
                f"{cls._KERNEL_MODES}, got {cls.pallas_kernels!r}")
        if cls.bucket_ladder not in cls._LADDERS:
            raise ValueError(
                "EngineConfig.bucket_ladder must be 'tuned' or 'pow2', "
                f"got {cls.bucket_ladder!r}")
        if not isinstance(cls.serving_warmup, bool):
            raise ValueError(
                "EngineConfig.serving_warmup must be a bool, got "
                f"{cls.serving_warmup!r}")
        if not isinstance(cls.serving_cluster, bool):
            raise ValueError(
                "EngineConfig.serving_cluster must be a bool, got "
                f"{cls.serving_cluster!r}")
        positive("serving_worker_residency_bytes",
                 cls.serving_worker_residency_bytes)
        if cls.serving_failover_max < 0:
            raise ValueError(
                "EngineConfig.serving_failover_max must be >= 0 (0 "
                "fails a moved request on first replica death), got "
                f"{cls.serving_failover_max!r}")
        if cls.cluster_workers < 0:
            raise ValueError(
                "EngineConfig.cluster_workers must be >= 0 (0 disables "
                f"the cluster plane), got {cls.cluster_workers!r}")
        positive("cluster_inflight_partitions",
                 cls.cluster_inflight_partitions)
        if not isinstance(cls.cluster_autoscale, bool):
            raise ValueError(
                "EngineConfig.cluster_autoscale must be a bool, got "
                f"{cls.cluster_autoscale!r}")
        if cls.cluster_min_workers < 1:
            raise ValueError(
                "EngineConfig.cluster_min_workers must be >= 1, got "
                f"{cls.cluster_min_workers!r}")
        if cls.cluster_max_workers < cls.cluster_min_workers:
            raise ValueError(
                "EngineConfig.cluster_max_workers must be >= "
                f"cluster_min_workers ({cls.cluster_min_workers}), got "
                f"{cls.cluster_max_workers!r}")
        positive("autoscale_window_s", cls.autoscale_window_s,
                 allow_none=False)
        positive("autoscale_cooldown_s", cls.autoscale_cooldown_s,
                 allow_none=False, exclusive=False)
        positive("autoscale_queue_wait_high_s",
                 cls.autoscale_queue_wait_high_s, allow_none=False)
        positive("autoscale_queue_wait_low_s",
                 cls.autoscale_queue_wait_low_s, allow_none=False)
        if cls.autoscale_queue_wait_low_s >= cls.autoscale_queue_wait_high_s:
            raise ValueError(
                "EngineConfig.autoscale_queue_wait_low_s must be < "
                "autoscale_queue_wait_high_s "
                f"({cls.autoscale_queue_wait_high_s}), got "
                f"{cls.autoscale_queue_wait_low_s!r} — the hysteresis "
                "gap is what keeps the worker set from flapping")
        if cls.autoscale_rows_per_worker_high < 1:
            raise ValueError(
                "EngineConfig.autoscale_rows_per_worker_high must be "
                f">= 1, got {cls.autoscale_rows_per_worker_high!r}")
        positive("cluster_federation_s", cls.cluster_federation_s)
        if cls.job_tenant is not None and (
                not isinstance(cls.job_tenant, str) or not cls.job_tenant):
            raise ValueError(
                "EngineConfig.job_tenant must be None or a non-empty "
                f"tenant string, got {cls.job_tenant!r}")
        if cls.durable_dir is not None and (
                not isinstance(cls.durable_dir, str) or not cls.durable_dir):
            raise ValueError(
                "EngineConfig.durable_dir must be None or a non-empty "
                f"directory path, got {cls.durable_dir!r}")


def _task_policy() -> resilience.RetryPolicy:
    if EngineConfig.task_retry_policy is not None:
        return EngineConfig.task_retry_policy
    return resilience.RetryPolicy(
        max_retries=EngineConfig.max_task_retries,
        base_delay_s=EngineConfig.task_retry_delay_s, jitter=0.0)


def _supervisor_config() -> _sup.SupervisorConfig:
    EngineConfig.validate()  # read-time knob validation
    return _sup.SupervisorConfig(
        task_timeout_s=EngineConfig.task_timeout_s,
        speculation=EngineConfig.speculation,
        speculation_quantile=EngineConfig.speculation_quantile,
        speculation_multiplier=EngineConfig.speculation_multiplier,
        speculation_min_runtime_s=EngineConfig.speculation_min_runtime_s,
        quarantine=EngineConfig.quarantine,
        quarantine_max_fatal=EngineConfig.quarantine_max_fatal)


# Process-wide partition pool, reused across materializations; rebuilt
# when EngineConfig.max_workers changes.
_pool: Optional[_futures.ThreadPoolExecutor] = None
_pool_workers: Optional[int] = None
_pool_lock = threading.Lock()
_POOL_PREFIX = "sparkdl-part"


def _executor() -> _futures.ThreadPoolExecutor:
    global _pool, _pool_workers
    with _pool_lock:
        if _pool is None or _pool_workers != EngineConfig.max_workers:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = _futures.ThreadPoolExecutor(
                EngineConfig.max_workers, thread_name_prefix=_POOL_PREFIX)
            _pool_workers = EngineConfig.max_workers
        return _pool


def _run_partition(index: int, batch: "Batch",
                   ops: Sequence[Callable[["Batch"], "Batch"]],
                   cancelled: Optional[threading.Event] = None) -> "Batch":
    """One partition task: classified retry per engine/supervisor.py
    (FATAL never retried, OOM surfaced, RETRYABLE backed off; the
    terminal TaskFailure carries the per-attempt history). ``cancelled``
    is the supervisor watchdog's abandonment signal (None inline)."""
    out = _sup.run_partition_task(
        index, batch, ops, policy=_task_policy(),
        deadline_s=EngineConfig.task_timeout_s,
        legacy_injector=EngineConfig.fault_injector,
        max_fatal_attempts=(EngineConfig.quarantine_max_fatal
                            if EngineConfig.quarantine else 1),
        cancelled=cancelled)
    if cancelled is None and telemetry.active() is not None:
        # inline paths only — supervised tasks are counted once per
        # WINNING attempt by the supervisor
        telemetry.count(telemetry.M_ENGINE_ROWS_OUT, out.num_rows)
        telemetry.count(telemetry.M_ENGINE_BYTES_OUT, out.nbytes)
    return out


def _cluster_dispatch() -> Callable[..., "Batch"]:
    """The partition runner of the supervised paths: ``_run_partition``
    in this process at the default ``cluster_workers = 0`` (the cluster
    package is never imported), else the process-wide router's
    :meth:`~sparkdl_tpu_torch.cluster.router.ClusterRouter.run_partition`.
    Resolved once per materialization or stream. The inline paths of a
    partition thread stay ``_run_partition``: a task already running on
    a cluster worker must not route back into a router."""
    if not EngineConfig.cluster_workers:
        return _run_partition
    from sparkdl_tpu_torch.cluster import router as _cluster_router

    router = _cluster_router.maybe_router()
    return _run_partition if router is None else router.run_partition


def _maybe_journal(partitions, columns, ops):
    """The job's durable journal, or None with ``durable_dir`` unset
    (then ``core/durability.py`` is not even imported)."""
    if not EngineConfig.durable_dir:
        return None
    from sparkdl_tpu_torch.core import durability

    return durability.maybe_journal(partitions, columns, ops)


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------


def _col_slice(col, start: int, stop: int):
    if isinstance(col, ImageColumn):
        return col.slice(start, stop)
    return col[start:stop]


def _col_take(col, idx: np.ndarray):
    if isinstance(col, ImageColumn):
        return col.take(idx)
    if isinstance(col, np.ndarray):
        return col[idx]
    return [col[i] for i in idx]


def _col_valid(col) -> np.ndarray:
    """Non-null mask of a column: an image struct's ``valid``; a numeric
    array has no nulls (NaN is a value, as in Arrow); a list or object
    array's None cells are null."""
    if isinstance(col, ImageColumn):
        return col.valid
    if isinstance(col, np.ndarray) and col.dtype != object:
        return np.ones(len(col), dtype=bool)
    return np.array([v is not None for v in col], dtype=bool)


def _col_concat(cols: List[Any]):
    """One column from per-partition pieces of one column (the port's
    ``pa.Table.from_batches``): image columns keep one contiguous block
    where every piece is uniform in one shape, numpy pieces of one row
    shape and dtype concatenate, anything else becomes a list of row
    values (numpy rows kept as arrays, scalars as Python values)."""
    pieces = [c for c in cols if len(c)] or cols[:1]
    if len(pieces) == 1:
        return pieces[0]
    if all(isinstance(c, ImageColumn) for c in pieces):
        meta = dict(origin=[o for c in pieces for o in c.origin],
                    **{f: np.concatenate([getattr(c, f) for c in pieces])
                       for f in ("height", "width", "nChannels", "mode",
                                 "valid")})
        blocks = [c.block for c in pieces]
        if all(b is not None and b.shape[1:] == blocks[0].shape[1:]
               and b.dtype == blocks[0].dtype for b in blocks):
            return ImageColumn(block=np.concatenate(blocks), **meta)
        return ImageColumn(data=[p for c in pieces for p in c._payloads()],
                           **meta)
    if all(isinstance(c, np.ndarray) and c.dtype != object
           and c.shape[1:] == pieces[0].shape[1:]
           and c.dtype == pieces[0].dtype for c in pieces):
        return np.concatenate(pieces)
    out: List[Any] = []
    for c in pieces:
        if isinstance(c, ImageColumn):
            out.extend(c.to_pylist())
        elif isinstance(c, np.ndarray) and c.ndim == 1:
            out.extend(c.tolist())
        else:
            out.extend(c)
    return out


def _col_values(col) -> List[Any]:
    """Per-row Python values (Spark Row analog)."""
    if isinstance(col, ImageColumn):
        return col.to_pylist()
    if isinstance(col, np.ndarray):
        return col.tolist()
    return [v.tolist() if isinstance(v, np.ndarray) else v for v in col]


def _as_column(values):
    if isinstance(values, (ImageColumn, np.ndarray)):
        return values
    values = list(values)
    present = [v for v in values if v is not None]
    if present and all(isinstance(v, dict) and set(v) == set(imageFields)
                       for v in present):
        return imageStructsToColumn(values)
    return values


class Batch:
    """One partition: named plain columns of equal length."""

    def __init__(self, columns: Dict[str, Any], num_rows: int) -> None:
        self.columns = columns
        self.num_rows = num_rows

    def column(self, name: str):
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"No such column: {name!r}") from None

    def with_column(self, name: str, col) -> "Batch":
        if len(col) != self.num_rows:
            raise ValueError(f"column {name!r} has {len(col)} values "
                             f"for {self.num_rows} rows")
        columns = dict(self.columns)
        columns[name] = col
        return Batch(columns, self.num_rows)

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.column(n) for n in names}, self.num_rows)

    def take(self, indices) -> "Batch":
        """The rows at ``indices`` (a sequence of row numbers), in order."""
        idx = np.asarray(indices, dtype=np.int64)
        return Batch({n: _col_take(c, idx) for n, c in self.columns.items()},
                     len(idx))

    def slice(self, start: int, stop: int) -> "Batch":
        stop = min(stop, self.num_rows)
        return Batch({n: _col_slice(c, start, stop)
                      for n, c in self.columns.items()},
                     max(0, stop - start))

    @property
    def nbytes(self) -> int:
        """Bytes of the numpy and image columns (list columns count 0)."""
        return sum(int(getattr(c, "nbytes", 0) or 0)
                   for c in self.columns.values())


def _split(columns: Dict[str, Any], num_partitions: Optional[int]
           ) -> List[Batch]:
    lengths = {len(c) for c in columns.values()}
    if len(lengths) > 1:
        raise ValueError(f"columns differ in length: {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    parts = max(1, min(num_partitions or 1, max(n, 1)))
    per = -(-n // parts) if n else 0
    if n == 0:
        return [Batch(dict(columns), 0)]
    return [Batch({k: _col_slice(c, s, s + per) for k, c in columns.items()},
                  min(per, n - s))
            for s in range(0, n, per)]


class DataFrame:
    """Immutable, lazily-evaluated partitioned frame of plain columns."""

    def __init__(self, partitions: List[Batch], columns: List[str],
                 ops: Optional[List[Callable[[Batch], Batch]]] = None):
        self._partitions = partitions
        self._columns = list(columns)
        self._ops = list(ops or [])
        self._materialized: Optional[List[Batch]] = None
        self._lock = threading.Lock()

    # -- constructors --------------------------------------------------------

    @classmethod
    def fromColumns(cls, columns: Dict[str, Any],
                    numPartitions: Optional[int] = None) -> "DataFrame":
        """Build from ``{name: numpy array | list | ImageColumn}``.
        ``numPartitions`` defaults to 1."""
        cols = {name: _as_column(v) for name, v in columns.items()}
        return cls(_split(cols, numPartitions), list(cols))

    @classmethod
    def fromRows(cls, rows: List[Dict[str, Any]],
                 numPartitions: Optional[int] = None) -> "DataFrame":
        names: List[str] = []
        for row in rows:
            names.extend(k for k in row if k not in names)
        return cls.fromColumns({n: [r.get(n) for r in rows] for n in names},
                               numPartitions)

    # -- metadata ------------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def numPartitions(self) -> int:
        return len(self._partitions)

    def __repr__(self) -> str:
        return (f"DataFrame[{', '.join(self._columns)}] "
                f"({self.numPartitions} partitions)")

    # -- execution -----------------------------------------------------------

    def _quarantine_probe(self, index: int) -> Batch:
        """Zero-row stand-in for a quarantined partition: the op chain
        run on an empty slice keeps the chain's output columns and the
        partition alignment while dropping the poisoned rows (if even
        this fails, the supervisor propagates the original failure)."""
        out = self._partitions[index].slice(0, 0)
        for op in self._ops:
            out = op(out)
        return out

    def _materialize(self) -> List[Batch]:
        with self._lock:
            if self._materialized is not None:
                return self._materialized
            if not self._ops:
                self._materialized = self._partitions
                return self._materialized
            ops = self._ops
            if threading.current_thread().name.startswith(_POOL_PREFIX):
                # nested materialization from inside a partition task:
                # run inline — waiting on the shared pool from one of its
                # own threads could deadlock. Classified retry still
                # applies; the deadline is cooperative only (no watchdog).
                self._materialized = [
                    _run_partition(i, b, ops)
                    for i, b in enumerate(self._partitions)]
                return self._materialized
            journal = _maybe_journal(self._partitions, self._columns, ops)
            if journal is not None:
                with telemetry.span(telemetry.SPAN_MATERIALIZE,
                                    partitions=len(self._partitions),
                                    ops=len(ops), durable=True):
                    self._materialized = self._materialize_durable(journal,
                                                                   ops)
                return self._materialized
            sup = _sup.PartitionSupervisor(
                _executor(), _supervisor_config(),
                quarantine_probe=self._quarantine_probe)
            dispatch = _cluster_dispatch()
            # the span is open while tasks are CREATED, so every
            # partition task's trace context parents under it
            with telemetry.span(telemetry.SPAN_MATERIALIZE,
                                partitions=len(self._partitions),
                                ops=len(ops)):
                self._materialized = sup.run_all(
                    [(i, lambda cancel, i=i, b=b: dispatch(
                        i, b, ops, cancel))
                     for i, b in enumerate(self._partitions)])
            return self._materialized

    def _durable_supervisor(self, journal) -> _sup.PartitionSupervisor:
        """A supervisor whose quarantine verdicts COMMIT: a poisoned
        partition's zero-row stand-in is journaled (``quarantined``), so
        a restarted job keeps the verdict instead of running it again."""
        return _sup.PartitionSupervisor(
            _executor(), _supervisor_config(),
            quarantine_probe=lambda i: journal.commit(
                i, self._quarantine_probe(i), quarantined=True))

    def _durable_runner(self, journal, i: int, ops,
                        dispatch: Callable[..., Batch]):
        """A partition runner that journals: count the attempt, run the
        op chain (here or through the cluster router: the journal wraps
        OUTSIDE the dispatch, so a re-dispatch after a worker dies never
        reruns a committed partition), spill and commit the result."""
        b = self._partitions[i]

        def run(cancel=None, i=i, b=b):
            journal.note_attempt(i)
            return journal.commit(i, dispatch(i, b, ops, cancel))

        return run

    def _materialize_durable(self, journal, ops) -> List[Batch]:
        """Durable materialization: verified committed partitions load
        from their spills, only the others run through the supervisor,
        each committing as it finishes. Order and bytes are those of an
        uninterrupted run."""
        committed = journal.resume()
        todo = [i for i in range(len(self._partitions)) if i not in committed]
        results: Dict[int, Batch] = {}
        if todo:
            sup = self._durable_supervisor(journal)
            dispatch = _cluster_dispatch()
            computed = sup.run_all(
                [(i, self._durable_runner(journal, i, ops, dispatch))
                 for i in todo])
            results.update(zip(todo, computed))
        for i in committed:
            results[i] = journal.load(i)
        return [results[i] for i in range(len(self._partitions))]

    def _stream_durable(self, journal, indices: List[int], prefetch: int
                        ) -> Iterator[Batch]:
        """Durable streaming: restored partitions come from their spills,
        the others stream through the supervisor (the same bounded
        prefetch), each in its place in the visit order."""
        committed = journal.resume()
        ops = self._ops
        todo = [i for i in indices if i not in committed]
        sup = self._durable_supervisor(journal)
        dispatch = _cluster_dispatch()

        def runners():
            for i in todo:
                yield i, self._durable_runner(journal, i, ops, dispatch)

        stream = sup.run_stream(runners(), prefetch=prefetch)
        try:
            for i in indices:
                if i in committed:
                    yield journal.load(i)
                else:
                    yield next(stream)
        finally:
            stream.close()

    def _joined_columns(self) -> Dict[str, Any]:
        """The whole frame as ``{name: column}``, its partitions' pieces
        joined in order (the port's ``toArrow``)."""
        batches = self._materialize()
        return {n: _col_concat([b.column(n) for b in batches])
                for n in self._columns}

    def collect(self) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for batch in self._materialize():
            values = {n: _col_values(batch.column(n)) for n in self._columns}
            rows.extend({n: values[n][i] for n in self._columns}
                        for i in range(batch.num_rows))
        return rows

    def count(self) -> int:
        return sum(b.num_rows for b in self._materialize())

    def isEmpty(self) -> bool:
        return self.count() == 0

    def cache(self) -> "DataFrame":
        """Materialize now and keep the partitions (frames derived from
        this one start from them)."""
        self._materialize()
        return self

    def foreachPartition(self, fn: Callable[[Batch], None]) -> None:
        for batch in self._materialize():
            fn(batch)

    def partitionsIter(self) -> Iterator[Batch]:
        """Iterate the materialized partitions (streaming consumption
        order)."""
        yield from self._materialize()

    def streamPartitions(self, prefetch: int = 2,
                         order: Optional[Sequence[int]] = None,
                         process_id: Optional[int] = None,
                         num_processes: Optional[int] = None
                         ) -> Iterator[Batch]:
        """Compute and yield partitions one at a time WITHOUT caching.

        At most ``prefetch + 1`` partitions are started and not yet
        yielded: each runs its op chain as a supervised task on the shared
        ``sparkdl-part`` pool (``PartitionSupervisor.run_stream``: the
        classified retry, the deadline watchdog, hedging and quarantine of
        ``_materialize``), and their forwards meet in the coalescing
        executor. Results come in visit order. Breaking out of the loop
        (or an error) cancels the partitions not yet started and waits
        for the running ones. Iterating again recomputes the op chain
        (``cache()`` first trades memory for computing once). A
        materialized frame yields its cached partitions, a frame without
        ops its source partitions; a stream started from a partition
        thread runs inline, as ``_materialize`` does.

        ``order``: visit the partitions in this index order.
        ``process_id``/``num_processes``: restrict this process to its
        round-robin share of the visit order (positions ``p, p+n,
        p+2n, …``); every process must pass the same ``order``.

        With ``EngineConfig.durable_dir`` set the stream is journaled
        (committed partitions come from their spills); with
        ``cluster_workers`` its partitions run on the cluster workers.
        """
        indices = list(order) if order is not None else list(range(
            len(self._partitions)))
        if num_processes is not None and num_processes > 1:
            if process_id is None or not 0 <= process_id < num_processes:
                raise ValueError(
                    f"process_id must be in [0, {num_processes}), got "
                    f"{process_id}")
            indices = indices[process_id::num_processes]
        with self._lock:
            materialized = self._materialized
        if materialized is not None:
            for i in indices:
                yield materialized[i]
            return
        if not self._ops:
            for i in indices:
                yield self._partitions[i]
            return
        parts, ops = self._partitions, self._ops
        if threading.current_thread().name.startswith(_POOL_PREFIX):
            # nested streaming from inside a partition task: run inline,
            # as _materialize does
            for i in indices:
                yield _run_partition(i, parts[i], ops)
            return
        journal = _maybe_journal(parts, self._columns, ops)
        if journal is not None:
            yield from self._stream_durable(journal, indices, prefetch)
            return
        sup = _sup.PartitionSupervisor(
            _executor(), _supervisor_config(),
            quarantine_probe=self._quarantine_probe)
        dispatch = _cluster_dispatch()

        def runners():
            for i in indices:
                yield i, (lambda cancel, i=i: dispatch(
                    i, parts[i], ops, cancel))

        yield from sup.run_stream(runners(), prefetch=prefetch)

    # -- transformations (lazy) ----------------------------------------------

    def _with_op(self, op: Callable[[Batch], Batch],
                 columns: List[str]) -> "DataFrame":
        if self._materialized is not None and self._ops:
            return DataFrame(self._materialized, columns, [op])
        return DataFrame(self._partitions, columns, self._ops + [op])

    def select(self, *cols: str) -> "DataFrame":
        names = list(cols)
        for name in names:
            if name not in self._columns:
                raise KeyError(f"No such column: {name!r}")
        return self._with_op(lambda b: b.select(names), names)

    def drop(self, *cols: str) -> "DataFrame":
        return self.select(*[c for c in self._columns if c not in cols])

    def _added(self, name: str) -> List[str]:
        return self._columns + ([name] if name not in self._columns else [])

    def withColumn(self, name: str, fn: Callable,
                   inputCols: Sequence[str]) -> "DataFrame":
        """Row-wise UDF column: ``fn(*input_values) -> value``."""
        def op(batch: Batch) -> Batch:
            inputs = [_col_values(batch.column(c)) for c in inputCols]
            values = [fn(*row) for row in zip(*inputs)] if inputs else []
            return batch.with_column(name, _as_column(values))

        return self._with_op(op, self._added(name))

    def withColumnBatch(self, name: str, fn: Callable[[Batch], Any]
                        ) -> "DataFrame":
        """Vectorized column: ``fn(batch) -> column`` (len == num_rows) —
        the hook model transformers use to stage a whole partition."""
        def op(batch: Batch) -> Batch:
            return batch.with_column(name, _as_column(fn(batch)))

        return self._with_op(op, self._added(name))

    def withConstantColumn(self, name: str, value: Any) -> "DataFrame":
        """Add a column holding ``value`` in every row (literal support)."""
        def op(batch: Batch) -> Batch:
            return batch.with_column(name, [value] * batch.num_rows)

        return self._with_op(op, self._added(name))

    def withColumnRenamed(self, existing: str, new: str) -> "DataFrame":
        if existing not in self._columns:
            raise KeyError(f"No such column: {existing!r}")
        names = [new if n == existing else n for n in self._columns]

        def op(batch: Batch) -> Batch:
            return Batch({(new if n == existing else n): c
                          for n, c in batch.columns.items()},
                         batch.num_rows)

        return self._with_op(op, names)

    def selectExpr(self, *exprs: str) -> "DataFrame":
        """SQL projection over columns, literals and registered UDFs.

        Supports ``col``, ``col as alias``, ``*``, numeric/'string'
        literals, and nested multi-argument UDF calls
        (``udf1(udf2(image), other_col) as out``), the model-as-SQL-UDF
        serving path. UDFs resolve against
        ``sparkdl_tpu_torch.udf.udf_registry``; the grammar lives in
        ``engine/sql_expr.py``.
        """
        from sparkdl_tpu_torch.engine import sql_expr

        frame = self
        temp_counter = [0]
        # (source column on frame, output name); temp columns drop by
        # omission, so one source column can feed several outputs
        projection: List[Tuple[str, str]] = []

        def fresh_temp() -> str:
            temp_counter[0] += 1
            return f"__sdl_expr_{temp_counter[0]}"

        def evaluate(node) -> str:
            """Materialize the expression as a column; returns its name."""
            nonlocal frame
            if isinstance(node, sql_expr.Column):
                if node.name not in self._columns:
                    raise KeyError(f"No such column: {node.name!r}")
                return node.name
            if isinstance(node, sql_expr.Literal):
                tmp = fresh_temp()
                frame = frame.withConstantColumn(tmp, node.value)
                return tmp
            if isinstance(node, sql_expr.Call):
                from sparkdl_tpu_torch.udf import udf_registry  # layering

                arg_cols = [evaluate(a) for a in node.args]
                tmp = fresh_temp()
                frame = udf_registry.get(node.fn).apply(frame, arg_cols, tmp)
                return tmp
            raise ValueError(f"Cannot evaluate {node!r}")

        for expr in exprs:
            node, alias = sql_expr.parse(expr)
            if isinstance(node, sql_expr.Star):
                projection.extend((c, c) for c in self._columns)
                continue
            src = evaluate(node)
            out = alias or (src if isinstance(node, sql_expr.Column)
                            else sql_expr.default_name(expr))
            projection.append((src, out))

        def project(batch: Batch) -> Batch:
            return Batch({out: batch.column(src) for src, out in projection},
                         batch.num_rows)

        return frame._with_op(project, [out for _, out in projection])

    def where(self, expr: str) -> "DataFrame":
        """SQL row filter: ``df.where("label = 1 AND score > 0.5")``.

        Comparisons (``= != <> < <= > >=``), ``AND/OR/NOT``, grouping
        parens and ``IS [NOT] NULL`` over columns and literals, with SQL
        null semantics (a comparison against NULL is not true, so the row
        drops). UDF calls belong in ``selectExpr``, not here.
        """
        from sparkdl_tpu_torch.engine import sql_expr

        node = sql_expr.parse_bool(expr)
        cols = sql_expr.bool_columns(node)
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"No such column: {c!r}")

        def pred(*vals) -> bool:
            return sql_expr.eval_bool(node, dict(zip(cols, vals))) is True

        return self.filter(pred, inputCols=cols)

    def createOrReplaceTempView(self, name: str) -> None:
        """Register this frame under ``name`` for :func:`sql` queries
        (the analog of Spark's temp-view registry)."""
        if not name or not name.replace("_", "").isalnum():
            raise ValueError(f"Bad view name {name!r}")
        with _views_lock:
            _temp_views[name] = self

    def filter(self, predicate: Callable, inputCols: Sequence[str]
               ) -> "DataFrame":
        """Keep the rows where ``predicate(*input_values)`` is true."""
        def op(batch: Batch) -> Batch:
            if not inputCols:
                # a constant predicate (where("1 = 1")) keeps all or none
                keep = bool(predicate())
                return batch.take(np.arange(batch.num_rows if keep else 0))
            inputs = [_col_values(batch.column(c)) for c in inputCols]
            return batch.take([i for i, row in enumerate(zip(*inputs))
                               if predicate(*row)])

        return self._with_op(op, self._columns)

    def dropna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """Drop the rows with a null in any of ``subset`` (default: every
        column)."""
        cols = list(subset or self._columns)

        def op(batch: Batch) -> Batch:
            mask = np.ones(batch.num_rows, dtype=bool)
            for c in cols:
                mask &= _col_valid(batch.column(c))
            return batch.take(np.flatnonzero(mask))

        return self._with_op(op, self._columns)

    # -- materializing transformations ---------------------------------------

    def limit(self, n: int) -> "DataFrame":
        """First n rows, materializing only as many partitions as needed."""
        if self._materialized is not None:
            taken = self._materialized
        else:
            taken = []
            count = 0
            for i, part in enumerate(self._partitions):
                batch = _run_partition(i, part, self._ops)
                taken.append(batch)
                count += batch.num_rows
                if count >= n:
                    break
            if not taken:
                return DataFrame(self._partitions, self._columns, self._ops)
        columns = {name: _col_concat([b.column(name) for b in taken])
                   for name in self._columns}
        return DataFrame.fromColumns(
            {name: _col_take(c, np.arange(min(n, len(c))))
             for name, c in columns.items()}, numPartitions=1)

    def randomSplit(self, weights: Sequence[float],
                    seed: int = 0) -> List["DataFrame"]:
        """Split rows into len(weights) disjoint frames (Spark's
        randomSplit: weights normalize; assignment is a seeded global
        permutation over the frame's rows in order, the reference's, so a
        seed puts the same rows in each split)."""
        if not weights or any(w <= 0 for w in weights):
            raise ValueError(f"weights must be positive, got {weights}")
        columns = self._joined_columns()
        n = self.count()
        perm = np.random.default_rng(seed).permutation(n)
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])
        out: List["DataFrame"] = []
        start = 0
        for i, b in enumerate(bounds):
            stop = n if i == len(weights) - 1 else int(round(b * n))
            idx = np.sort(perm[start:stop])
            out.append(DataFrame.fromColumns(
                {name: _col_take(c, idx) for name, c in columns.items()},
                numPartitions=max(1, self.numPartitions)))
            start = stop
        return out


# ---------------------------------------------------------------------------
# Temp views + sql(), the SQL serving entry
# ---------------------------------------------------------------------------

_temp_views: Dict[str, DataFrame] = {}
# views are process-wide, registered and read from any thread
_views_lock = threading.Lock()


def table(name: str) -> DataFrame:
    """The frame registered under ``name`` (createOrReplaceTempView)."""
    with _views_lock:
        try:
            return _temp_views[name]
        except KeyError:
            raise KeyError(
                f"No temp view {name!r}; registered: {sorted(_temp_views)}"
            ) from None


def sql(query: str) -> DataFrame:
    """``SELECT <exprs> FROM <view> [WHERE <condition>]`` over temp views.

    Expressions run through :meth:`DataFrame.selectExpr` (registered
    UDFs, nesting, aliases, literals, ``*``), the optional WHERE through
    :meth:`DataFrame.where`; lazy like every frame transformation.
    """
    from sparkdl_tpu_torch.engine import sql_expr

    parts = sql_expr.split_query(query)
    frame = table(parts["view"])
    if parts["where"]:
        frame = frame.where(parts["where"])
    return frame.selectExpr(*parts["select"])
