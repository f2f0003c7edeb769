"""Fused inference fast path for InceptionV3, ported from
``sparkdl_tpu.models.inception_fast``.

An apply over the tensors of a :class:`~.inception.InceptionV3` module,
in the reference's op order:

- **BN folding**: each unit's BN folds into its bias-free conv in float32
  (``k' = k·rsqrt(var + eps)``, ``b' = β − mean·rsqrt(var + eps)``), cast
  once to the compute dtype; the conv epilogue is one bias add + ReLU.
- **Branch fusion**: the parallel 1×1 convs at the head of each inception
  block read the same input, so they run as ONE conv with their kernels
  concatenated along the output channels, then split.
- The pool branch stays ``avg_pool_same`` → 1×1 conv.

These convs are plain ``F.conv2d`` (XLA convs in the reference, outside
any Pallas kernel), so the fast path launches no ``pw1x1``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    KERAS_BN_EPS, avg_pool_same, conv2d_nhwc, global_avg_pool, max_pool,
)


def _folded(module: nn.Module, idx: int, compute_dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN-folded (kernel, bias) of unit ``cb{idx}``: folded in float32 on
    weight-sized tensors, cast once to the compute dtype."""
    unit = module.get_submodule(f"cb{idx}")
    bn = unit.bn
    inv = torch.rsqrt(bn.running_var.float() + KERAS_BN_EPS)
    if bn.weight is not None:
        inv = inv * bn.weight.float()
    k = unit.conv.weight.float() * inv.reshape(-1, 1, 1, 1)
    b = bn.bias.float() - bn.running_mean.float() * inv
    return k.to(compute_dtype), b.to(compute_dtype)


def _conv(x, kernel, bias, strides=1, padding="SAME", relu=True):
    y = conv2d_nhwc(x, kernel, strides, padding) + bias
    return torch.relu(y) if relu else y


def _cb(module, x, idx, strides=1, padding="SAME"):
    k, b = _folded(module, idx, x.dtype)
    return _conv(x, k, b, strides, padding)


def _cb_pool(module, x, idx):
    """Inception pool branch: ``avg_pool_same(x)`` then the 1×1 unit."""
    return _cb(module, avg_pool_same(x), idx)


def _cb_fused(module, x, idxs: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """The parallel 1×1 units ``idxs`` as ONE conv; returns the splits."""
    folded = [_folded(module, i, x.dtype) for i in idxs]
    k = torch.cat([f[0] for f in folded], dim=0)
    b = torch.cat([f[1] for f in folded], dim=0)
    y = _conv(x, k, b)
    return torch.split(y, [f[0].shape[0] for f in folded], dim=-1)


def inception_v3_fast_apply(module: nn.Module, x: torch.Tensor,
                            include_top: bool = False,
                            pooling: Optional[str] = "avg",
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Inference-only InceptionV3 forward over an ``InceptionV3`` module's
    tensors; call order mirrors ``models/inception.py`` (cb0 … cb93)."""
    x = x.to(compute_dtype)

    # Stem
    x = _cb(module, x, 0, strides=2, padding="VALID")
    x = _cb(module, x, 1, padding="VALID")
    x = _cb(module, x, 2)
    x = max_pool(x, 3, 2)
    x = _cb(module, x, 3, padding="VALID")
    x = _cb(module, x, 4, padding="VALID")
    x = max_pool(x, 3, 2)

    # mixed 0..2: 35×35 inception-A
    idx = 5
    for _ in range(3):
        b1, b5, b3 = _cb_fused(module, x, (idx, idx + 1, idx + 3))
        b5 = _cb(module, b5, idx + 2)                       # 5×5
        b3 = _cb(module, b3, idx + 4)
        b3 = _cb(module, b3, idx + 5)
        bp = _cb_pool(module, x, idx + 6)
        x = torch.cat([b1, b5, b3, bp], dim=-1)
        idx += 7

    # mixed 3: reduction (idx == 26)
    b3 = _cb(module, x, idx, strides=2, padding="VALID")
    bd = _cb(module, x, idx + 1)
    bd = _cb(module, bd, idx + 2)
    bd = _cb(module, bd, idx + 3, strides=2, padding="VALID")
    bp = max_pool(x, 3, 2)
    x = torch.cat([b3, bd, bp], dim=-1)
    idx += 4

    # mixed 4..7: 17×17 inception-B (idx == 30)
    for _ in range(4):
        b1, b7, bd = _cb_fused(module, x, (idx, idx + 1, idx + 4))
        b7 = _cb(module, b7, idx + 2)                       # 1×7
        b7 = _cb(module, b7, idx + 3)                       # 7×1
        bd = _cb(module, bd, idx + 5)                       # 7×1
        bd = _cb(module, bd, idx + 6)                       # 1×7
        bd = _cb(module, bd, idx + 7)                       # 7×1
        bd = _cb(module, bd, idx + 8)                       # 1×7
        bp = _cb_pool(module, x, idx + 9)
        x = torch.cat([b1, b7, bd, bp], dim=-1)
        idx += 10

    # mixed 8: reduction (idx == 70)
    b3, b7 = _cb_fused(module, x, (idx, idx + 2))
    b3 = _cb(module, b3, idx + 1, strides=2, padding="VALID")
    b7 = _cb(module, b7, idx + 3)                           # 1×7
    b7 = _cb(module, b7, idx + 4)                           # 7×1
    b7 = _cb(module, b7, idx + 5, strides=2, padding="VALID")
    bp = max_pool(x, 3, 2)
    x = torch.cat([b3, b7, bp], dim=-1)
    idx += 6

    # mixed 9..10: 8×8 inception-C (idx == 76)
    for _ in range(2):
        b1, b3, bd = _cb_fused(module, x, (idx, idx + 1, idx + 4))
        b3a = _cb(module, b3, idx + 2)                      # 1×3
        b3b = _cb(module, b3, idx + 3)                      # 3×1
        b3 = torch.cat([b3a, b3b], dim=-1)
        bd = _cb(module, bd, idx + 5)                       # 3×3
        bda = _cb(module, bd, idx + 6)                      # 1×3
        bdb = _cb(module, bd, idx + 7)                      # 3×1
        bd = torch.cat([bda, bdb], dim=-1)
        bp = _cb_pool(module, x, idx + 8)
        x = torch.cat([b1, b3, bd, bp], dim=-1)
        idx += 9

    if include_top:
        x = global_avg_pool(x)
        p = module.predictions
        return torch.softmax(F.linear(x, p.weight.to(x.dtype),
                                      p.bias.to(x.dtype)), dim=-1)
    if pooling == "avg":
        return global_avg_pool(x)
    if pooling == "max":
        return x.amax(dim=(1, 2))
    return x
