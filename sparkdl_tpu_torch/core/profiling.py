"""Phase timers, trace annotations and trace capture.

A port of ``sparkdl_tpu.core.profiling``, in three layers:

1. **Phase timers** — always-on wall-clock accumulators around the host
   pipeline's phases (decode, stage, device apply, compile). Read with
   :func:`phase_stats`; they answer "where does the host time of a
   partition go?" without a trace.
2. **Trace annotations** — :func:`annotate` adds a named range to any
   ``torch.profiler`` trace being captured (``record_function``), a span
   to the active telemetry scope, and feeds the phase timers.
3. **Trace capture** — :func:`maybe_trace` wraps a block in
   ``torch.profiler.profile`` when ``SPARKDL_PROFILE_DIR`` is set and
   writes a Chrome trace there, so any workload can be traced without
   code changes.

PyTorch returns before the card finishes, so a phase that launches work
on the card times its enqueue, not the card's execution; the phase that
waits for the card (the one device-to-host fetch of a partition) holds
the rest.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

from sparkdl_tpu_torch.core import telemetry

_lock = threading.Lock()
_phase_totals: Dict[str, float] = {}
_phase_counts: Dict[str, int] = {}

PROFILE_DIR_ENV = "SPARKDL_PROFILE_DIR"
_trace_ids = itertools.count(1)

# Canonical phase names of the async input pipeline (core/pipeline.py).
# HOST_WAIT is the starvation timer: seconds the device-driving thread
# waited for the staging thread to deliver a chunk. With the pipeline
# overlapped, host ETL phases accumulate on the STAGING thread while the
# consumer drives the card, so phase totals can sum past wall-clock;
# HOST_WAIT is the serial remainder the host still costs the card.
HOST_WAIT = "sparkdl.host_wait"
STAGE_BATCH = "sparkdl.stage_batch"
DEVICE_SYNC = "sparkdl.device_sync"

# Host ETL phases whose time the pipeline can hide behind the card's
# (overlap accounting: overlap_ratio).
HOST_ETL_PHASES = ("sparkdl.decode", "sparkdl.stage", STAGE_BATCH,
                   "sparkdl.host_stage", "sparkdl.host_resize")


@contextlib.contextmanager
def annotate(name: str, **attributes: Any) -> Iterator[None]:
    """Named range: feeds the phase timers, any ``torch.profiler`` trace
    being captured, and — when a ``core.telemetry`` scope is active — the
    telemetry tracer. ``attributes`` ride on the telemetry span only; the
    phase timers stay name-keyed aggregates."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with telemetry.span(name, **attributes):
        with record_function(name):
            yield
    dt = time.perf_counter() - t0
    with _lock:
        _phase_totals[name] = _phase_totals.get(name, 0.0) + dt
        _phase_counts[name] = _phase_counts.get(name, 0) + 1


def add_phase_time(name: str, seconds: float, count: int = 1) -> None:
    """Feed a phase timer directly (no span) — for waits measured by the
    async pipeline, where a range per queue get would be noise."""
    with _lock:
        _phase_totals[name] = _phase_totals.get(name, 0.0) + seconds
        _phase_counts[name] = _phase_counts.get(name, 0) + count


def overlap_stats() -> Dict[str, float]:
    """Overlap accounting for the async input pipeline.

    ``host_etl_s``: host decode/stage seconds (the work the pipeline can
    hide). ``host_wait_s``: seconds the device-driving thread waited on
    the host (starvation). ``overlap_ratio``: the share of host ETL hidden
    behind the card — 1.0 means the host never held the card back, 0.0
    fully serial.
    """
    stats = phase_stats()
    etl = sum(stats[p]["total_s"] for p in HOST_ETL_PHASES if p in stats)
    wait = stats.get(HOST_WAIT, {}).get("total_s", 0.0)
    ratio = 1.0 if etl <= 0 else max(0.0, min(1.0, 1.0 - wait / etl))
    return {"host_etl_s": etl, "host_wait_s": wait, "overlap_ratio": ratio}


def phase_stats(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """{phase: {total_s, count, mean_s}} accumulated since last reset."""
    with _lock:
        out = {
            name: {
                "total_s": total,
                "count": _phase_counts[name],
                "mean_s": total / _phase_counts[name],
            }
            for name, total in _phase_totals.items()
        }
        if reset:
            _phase_totals.clear()
            _phase_counts.clear()
    return out


def reset_phase_stats() -> None:
    phase_stats(reset=True)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None) -> Iterator[bool]:
    """Capture a ``torch.profiler`` trace (host ranges, and the card's
    kernels when CUDA is available) when enabled, else no-op; the Chrome
    trace goes to ``<dir>/sparkdl_trace_<pid>_<n>.json``.

    Enabled when ``trace_dir`` is passed or ``SPARKDL_PROFILE_DIR`` is set.
    Yields whether tracing is active.
    """
    target = trace_dir or os.environ.get(PROFILE_DIR_ENV)
    if not target:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with profile(activities=activities) as prof:
        yield True
    path = os.path.join(target, f"sparkdl_trace_{os.getpid()}_"
                                f"{next(_trace_ids)}.json")
    prof.export_chrome_trace(path)

