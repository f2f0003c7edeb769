"""The cluster worker process: one whole inference stack per process.

The port of ``sparkdl_tpu.cluster.worker``. Each worker is a
**spawn-context** process (never fork: the coordinator holds a live CUDA
context, which a forked child must not inherit) with everything a
single-process run has: its own CUDA context and copy of the weights, its
own ``DeviceExecutor`` and captured graphs (reached through the op chain
as inline execution reaches them), and its own ``Telemetry(run_id=...)``
scope pinned to the COORDINATOR's run id, so every worker's spans and
metrics carry the run identity the merged report
(``cluster/aggregate.py``) is keyed on. On one card the workers share
it.

Transport, as the decode pool's: a PRIVATE task queue in and a PRIVATE
result pipe back per worker (one writer per pipe: a worker killed
mid-send corrupts only its own channel, and the router's collector sees
its death as EOF). Op chains ship once per distinct chain
(``cluster/transport.py``: closures by value, weights as CPU arrays),
keyed by the token the router derives from ``durability.ops_token``;
tasks then name the token, so the weights cross the pipe once per
worker, not once per partition. Partitions travel in the spill encoding
of ``core/durability.py``.

Boot: the coordinator's ``EngineConfig`` snapshot is restored with the
cluster, durability and decode-pool knobs forced off (a worker never
starts a cluster of its own, journals the coordinator's job or nests a
decode pool), the kernels' libraries may be loaded but not built (the
coordinator built them all before it spawned a worker), PyTorch's TF32
switches are set as the coordinator's are, and on the card the CUDA
context is made before the first task.

Protocol (coordinator -> worker queue):
  ``("ops", token, blob)``                  register an op chain
  ``("srv_*", ...)``                        the cluster serving plane
      (``serving/cluster.py``): deploy, retire and pin fan-out, the
      prepares of a two-phase cutover, and routed predicts. The first
      ``srv_*`` message builds this worker's ``WorkerServingPlane`` (a
      registry of its own, an optional residency budget): a batch-only
      run never imports the serving plane
  ``("task", task_id, index, token, payload, crash, preempt, tenant,
  ctx)``  run one partition. ``ctx`` is the coordinator's dispatch
      span (None with tracing off), which the worker's
      ``sparkdl.cluster_task`` span parents under; ``crash`` (the armed
      ``cluster_worker_kill``) SIGKILLs this process on receipt;
      ``preempt`` (the armed ``cluster_worker_preempt``) SIGTERMs it
      before the task runs: the task still completes, and the drain
      reruns nothing; ``tenant`` (``EngineConfig.job_tenant``) is entered
      as an ``executor.tenant_scope`` around the op chain
  ``("pull_ring",)``                        reply with the current span
      ring (the worker keeps running): a mid-run postmortem
  ``("pull_device",)``                      reply with the ``device``
      section as it stands (launch counts, forwards): a pass's counts
      are the difference of two pulls
  ``None``                                  the poison pill
(worker -> coordinator pipe):
  ``("ok", task_id, payload, meta)`` / ``("err", task_id, type, msg,
  kind)``  a task's result, or its error with its ``classify`` kind
  ``("srv_ok", req_id, blob, meta)`` / ``("srv_err", req_id, type,
  msg, kind)`` / ``("srv_prepared", req_id, ok, err, resident_bytes)``
      a routed predict's answer (a pickle of numpy arrays) or error, and
      a cutover prepare's ack or nack
  ``("draining", worker_id)``               SIGTERM received: the router
      stops dispatching here and pills this worker once its in-flight
      tasks finish (the worker never exits on SIGTERM by itself, so no
      queued task is stranded)
  ``("frame", worker_id, frame)``           a metrics-federation frame
      (``EngineConfig.cluster_federation_s``), between tasks
  ``("ring", worker_id, ring)``             the ``pull_ring`` reply
  ``("device", worker_id, section)``        the ``pull_device`` reply
  ``("final", worker_id, snapshot)``        the last message before EOF:
      the end-of-run snapshot, with the span ring rebased onto the
      coordinator's clock when tracing is on, and the ``device``
      section (launch counts, forwards, boot times, reserved memory),
      and the ``serving`` section of a worker that served
"""

from __future__ import annotations

import os
import signal
import time
from queue import Empty
from typing import Any, Dict

# Idle orphan watch, as the decode pool's: a coordinator killed with -9
# never sends the pill, so reparenting is the worker's only sign.
_ORPHAN_POLL_S = 5.0

# True inside a spawned cluster worker (set by _worker_main): a worker
# never routes its partitions into a router of its own
# (``router.maybe_router`` checks this; the restored config also has
# cluster_workers = 0).
_IN_WORKER = False


def _device_section(boot: Dict[str, float]) -> Dict[str, Any]:
    """This process's kernel launches, forwards, captures, boot times,
    allocated and reserved card memory and native image loader
    (``loader.status``)."""
    import torch

    from sparkdl_tpu_torch.core import kernels, model_function, profiling
    from sparkdl_tpu_torch.native import loader

    counts = kernels.launch_counts()
    compiles = profiling.phase_stats().get("sparkdl.compile") or {}
    return {"launches": counts["launches"],
            "launches_by_body": counts["by_body"],
            "forwards": sum(p.replays for p in model_function.programs()),
            "captures": int(compiles.get("count", 0)),
            "boot": boot,
            "memory_allocated": (torch.cuda.memory_allocated()
                                 if torch.cuda.is_initialized() else None),
            "memory_reserved": (torch.cuda.memory_reserved()
                                if torch.cuda.is_initialized() else None),
            "native_loader": loader.status()}


def _worker_main(worker_id: int, tasks: Any, conn: Any, owner_pid: int,
                 run_id: str, boot_blob: bytes, clock_conn: Any = None,
                 spawned_at: float = 0.0) -> None:
    """The worker's loop: run partition op chains until the ``None``
    pill, then ship the end-of-run snapshot and EOF.

    Retry, hedging, quarantine, deadlines and fault injection stay in
    the coordinator (the router goes through ``engine/supervisor.py``);
    this loop runs one attempt's op chain and reports the outcome. An
    exception ships back with its ``resilience.classify`` kind, so the
    coordinator's retry loop sees what an attempt in its own process
    would have raised. A task that fails here (no card, a library that
    does not load) fails with that error: nothing runs on the CPU in its
    place. Only the armed ``cluster_worker_kill`` marker, decided in the
    coordinator and carried on the task, kills the process.
    """
    global _IN_WORKER
    _IN_WORKER = True
    started = time.time()
    from sparkdl_tpu_torch.cluster import aggregate, transport
    from sparkdl_tpu_torch.core import (cuda_build, durability, executor,
                                        health, profiling, resilience,
                                        telemetry)
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    boot = transport.loads(boot_blob)
    EngineConfig.restore(boot["config"])
    cuda_build.forbid_builds()
    if boot.get("tf32") is not None:
        # the coordinator's TF32 switches, not PyTorch's defaults
        import torch

        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = boot["tf32"]
    imported = time.time()
    if EngineConfig.device.startswith("cuda"):
        import torch

        torch.cuda.init()
        torch.empty(1, device=EngineConfig.device)  # the context, now
    boot_s: Dict[str, float] = {
        "spawn_s": started - spawned_at if spawned_at else 0.0,
        "imports_s": imported - started,
        "cuda_init_s": time.time() - imported}
    name = f"sparkdl-cluster-{worker_id}"
    # SIGTERM with a warning (a preemption): the handler only sets a
    # flag (sending on the pipe from a signal frame could tear a
    # message); the loop sees it at its next turn and tells the router,
    # which owns the drain
    preempted = {"flag": False, "sent": False}

    def _on_sigterm(signum, frame):  # pragma: no cover - signal frame
        preempted["flag"] = True

    signal.signal(signal.SIGTERM, _on_sigterm)
    # the coordinator's root span (None: tracing off) and the offset of
    # this process's perf_counter_ns onto the coordinator's: together
    # they put this worker's spans on the coordinator's timeline
    coord_root = boot.get("root_ctx")
    clock_offset = 0
    if clock_conn is not None:
        clock_offset = telemetry.clock_handshake(clock_conn)
        clock_conn.close()
    ops_cache: Dict[str, Any] = {}
    serving_plane = None
    tasks_done = 0
    rows_out = 0
    exec_s_total = 0.0
    # the monitor OUTSIDE the telemetry scope (the nesting that folds
    # health into reports); out_dir="" writes no files: the snapshot
    # ships over the pipe
    monitor = health.HealthMonitor(name)
    fed_s = EngineConfig.cluster_federation_s
    frame_seq = 0
    next_frame = (time.monotonic() + fed_s) if fed_s else None
    with monitor, telemetry.Telemetry(
            name=name, out_dir="", run_id=run_id,
            process_scope=f"w{worker_id}",
            exemplar_k=int(boot.get("exemplar_k") or 0)) as tel:
        # ambient worker spans (captures, the executor's launches) parent
        # under the coordinator's root, not this worker's own
        telemetry.attach(coord_root)

        def _ring():
            remap = ({tel.root_context.span_id: coord_root.span_id}
                     if coord_root is not None else None)
            return tel.tracer.export_ring(
                clock_offset_ns=clock_offset, process=name,
                parent_remap=remap)

        while True:
            if next_frame is not None and time.monotonic() >= next_frame:
                frame_seq += 1
                frame = aggregate.build_frame(
                    name, worker_id, frame_seq, tel,
                    clock_offset_ns=clock_offset)
                if frame is not None:
                    conn.send(("frame", worker_id, frame))
                next_frame = time.monotonic() + fed_s
            if preempted["flag"] and not preempted["sent"]:
                # tell the router, then KEEP working: in-flight and
                # queued tasks run to completion; the router pills this
                # worker once its in-flight set is empty
                preempted["sent"] = True
                health.record(health.CLUSTER_PREEMPTION_NOTICE,
                              worker=name)
                conn.send(("draining", worker_id))
            try:
                timeout = _ORPHAN_POLL_S
                if next_frame is not None:
                    timeout = min(timeout,
                                  max(0.01, next_frame - time.monotonic()))
                msg = tasks.get(timeout=timeout)
            except Empty:
                if os.getppid() != owner_pid:  # orphaned: owner died hard
                    conn.close()
                    return
                continue
            if msg is None:
                break
            if msg[0] == "ops":
                _, token, blob = msg
                t0 = time.time()
                ops_cache[token] = transport.loads(blob)
                boot_s.setdefault("first_ops_s", time.time() - t0)
                boot_s.setdefault("ready_s", time.time() - spawned_at
                                  if spawned_at else 0.0)
                continue
            if msg[0] == "pull_ring":
                conn.send(("ring", worker_id, _ring()))
                continue
            if msg[0] == "pull_device":
                conn.send(("device", worker_id, _device_section(boot_s)))
                continue
            if isinstance(msg[0], str) and msg[0].startswith("srv_"):
                if serving_plane is None:
                    from sparkdl_tpu_torch.serving.cluster import \
                        WorkerServingPlane

                    serving_plane = WorkerServingPlane(worker_id, name,
                                                       conn)
                serving_plane.handle(msg)
                continue
            _, task_id, index, token, payload, crash, preempt, tenant, \
                ctx = msg
            if crash:
                # injected worker death: as hard as a lost machine, no
                # cleanup, no final snapshot
                os.kill(os.getpid(), signal.SIGKILL)
            if preempt:
                # injected SIGTERM with a warning: the flag is set before
                # the task runs, so the notice goes out at the NEXT turn
                # and this task still completes
                os.kill(os.getpid(), signal.SIGTERM)
            t0 = time.perf_counter()
            try:
                ops = ops_cache[token]
                out = durability.decode_batch(payload)
                with executor.tenant_scope(tenant), \
                        telemetry.span(telemetry.SPAN_CLUSTER_TASK,
                                       parent=ctx, partition=index,
                                       cluster_worker=worker_id):
                    for op in ops:
                        out = op(out)
                result = durability.encode_batch(out)
            except Exception as e:  # noqa: BLE001 - re-raised coordinator-side
                conn.send(("err", task_id, type(e).__name__, str(e),
                           resilience.classify(e)))
                continue
            dt = time.perf_counter() - t0
            tasks_done += 1
            rows_out += out.num_rows
            exec_s_total += dt
            conn.send(("ok", task_id, result,
                       {"exec_s": dt, "rows": out.num_rows}))
        span_ring = _ring() if coord_root is not None else None
        snapshot = aggregate.build_snapshot(
            name, os.getpid(), tel, monitor, tasks=tasks_done,
            rows=rows_out, exec_s=exec_s_total,
            phases=profiling.phase_stats(), span_ring=span_ring,
            serving=(serving_plane.stats()
                     if serving_plane is not None else None),
            device=_device_section(boot_s))
    conn.send(("final", worker_id, snapshot))
    conn.close()
