"""Fixed-shape batching: chunk rows, pad each chunk to its rung.

A port of ``sparkdl_tpu.core.batching``'s pad/bucket helpers. PyTorch
runs eagerly, so fixed shapes are not needed to avoid recompiles; the
port keeps the power-of-two ladder so that the kernels see the same few
shapes the JAX package compiles for (and a later CUDA-graph capture can
key on them). ``BucketPlanner`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


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
    chunk pads to its rung, not to the full batch)."""
    b = min_bucket
    while b < n:
        b <<= 1
    return max(min(b, batch_size), n)


def run_batched(fn: Callable[[torch.Tensor], torch.Tensor],
                array: np.ndarray, batch_size: int,
                device: torch.device) -> np.ndarray:
    """Apply ``fn`` over all rows in padded chunks; returns numpy.

    Each chunk is padded on the host into a (pinned, on CUDA) staging
    buffer and uploaded with ONE host-to-device copy; pad rows are sliced
    off on the device, the chunk outputs concatenated there, and the
    result fetched with one device-to-host copy (a bfloat16 result as
    float32)."""
    n = array.shape[0]
    if n == 0:
        raise ValueError("run_batched needs at least one row")
    pin = device.type == "cuda"
    outs: List[torch.Tensor] = []
    for start in range(0, n, batch_size):
        chunk = array[start:start + batch_size]
        padded, n_valid = pad_batch(chunk, bucket_size(len(chunk),
                                                       batch_size))
        host = torch.from_numpy(np.ascontiguousarray(padded))
        if pin:
            host = host.pin_memory()
        with torch.inference_mode():
            out = fn(host.to(device, non_blocking=True))
        outs.append(out[:n_valid])
    result = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    if result.dtype == torch.bfloat16:  # numpy has no bfloat16
        result = result.float()
    return result.cpu().numpy()
