"""Structured per-step training metrics.

A port of ``sparkdl_tpu.train.metrics``: a metrics dict per step (loss,
accuracy, examples/sec), pluggable sinks (stdout JSONL first), and the
device's memory counters under the reference's keys.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from sparkdl_tpu_torch.core import telemetry


def hbm_stats(device=None) -> Dict[str, int]:
    """Bytes in use / limit / peak for one card, from
    ``torch.cuda.memory_stats`` (tensors allocated by PyTorch's caching
    allocator); {} on the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(device).total_memory),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))}


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) or (
        isinstance(v, torch.Tensor) and v.numel() == 1)


class MetricsLogger:
    """Collects per-step metric dicts and forwards them to sinks.

    A sink is ``callable(record: dict) -> None``. ``jsonl`` writes one JSON
    object per record to the given stream (stdout default).

    Deferred records (``log_step(..., defer=True)``) keep their metric
    tensors on the device, untouched: reading one would block until its
    step has run and serialize the pipelined train loop. They materialize
    in one batched device-to-host copy at :meth:`flush`, which
    ``Trainer.fit`` calls only at its sync points. ``examples_per_sec`` of
    a deferred record is the rate over the flush window (examples since
    the last flush / wall seconds since it).
    """

    def __init__(self, sinks: Optional[List[Callable]] = None,
                 jsonl_stream=None, every: int = 1) -> None:
        self.sinks = list(sinks or [])
        if jsonl_stream is not None or not self.sinks:
            stream = jsonl_stream or sys.stdout
            self.sinks.append(
                lambda rec: print(json.dumps(rec, default=float), file=stream))
        self.every = max(1, every)
        self.history: List[Dict[str, Any]] = []
        self._t_last: Optional[float] = None
        self._pending: List[tuple] = []  # (step, device_metrics, examples)

    def _materialize(self, step: int, metrics: Dict[str, Any],
                     rate: Optional[float]) -> Dict[str, Any]:
        record: Dict[str, Any] = {"step": int(step)}
        for k, v in metrics.items():
            record[k] = float(v) if _is_number(v) else v
        if rate is not None:
            record["examples_per_sec"] = rate
        self.history.append(record)
        if step % self.every == 0:
            for sink in self.sinks:
                sink(record)
        return record

    def log_step(self, step: int, metrics: Dict[str, Any],
                 examples: Optional[int] = None,
                 defer: bool = False) -> Optional[Dict[str, Any]]:
        if defer:
            self._pending.append((int(step), metrics, examples))
            return None
        now = time.perf_counter()
        rate = None
        if examples is not None and self._t_last is not None:
            dt = now - self._t_last
            if dt > 0:
                rate = examples / dt
        self._t_last = now
        return self._materialize(step, metrics, rate)

    def flush(self) -> List[Dict[str, Any]]:
        """Materialize deferred records (ONE batched device-to-host copy),
        append them to history in step order and forward due ones to
        sinks. Returns the flushed records. This waits for every step
        logged since the previous flush: call it at sync points."""
        if not self._pending:
            return []
        pending, self._pending = self._pending, []
        now = time.perf_counter()
        tensors = [v for _, m, _ in pending for v in m.values()
                   if isinstance(v, torch.Tensor)]
        values = iter(torch.stack([t.detach().float().reshape(())
                                   for t in tensors]).cpu().tolist()
                      if tensors else [])
        fetched = [{k: next(values) if isinstance(v, torch.Tensor) else v
                    for k, v in m.items()} for _, m, _ in pending]
        window_examples = sum(e for _, _, e in pending if e is not None)
        rate = None
        if self._t_last is not None and window_examples:
            dt = now - self._t_last
            if dt > 0:
                rate = window_examples / dt
                telemetry.gauge_set(telemetry.M_EXAMPLES_PER_SEC, rate)
        self._t_last = now
        return [self._materialize(step, metrics,
                                  rate if examples is not None else None)
                for (step, _, examples), metrics in zip(pending, fetched)]
