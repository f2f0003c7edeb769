"""Fused inference fast path for the ResNet v1 family, ported from
``sparkdl_tpu.models.resnet_fast``.

An apply over the tensors of a :class:`~.resnet.ResNet` module, in the
reference's op order:

- **BN folding**: every conv carries a bias and is followed by BN, so at
  inference ``BN(conv(x) + b)`` folds into one conv with
  ``k' = k·γ·rsqrt(var + eps)`` and ``b' = (b − mean)·γ·rsqrt(var + eps)
  + β``, folded in float32 and cast once to the compute dtype.
- **Shortcut fusion**: in each stage's downsampling block the shortcut
  ``conv_0`` (4F out) and the main path's ``conv_1`` (F out) share the
  input, the 1×1 kernel and the stride, so they run as ONE 5F-wide conv,
  split after.

As in the reference, the registry does not select it (only InceptionV3
has a fast path there); ``chip_smoke.py`` times it beside the module.
Its convs are plain ``F.conv2d``, as the reference's are XLA convs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    RESNET_BN_EPS, conv2d_nhwc, global_avg_pool, max_pool, pad2d,
)


def _folded(conv: nn.Module, bn: nn.Module, compute_dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN-folded (kernel, bias) of a biased conv and its BN: float32
    math, one cast."""
    inv = torch.rsqrt(bn.running_var.float() + RESNET_BN_EPS) \
        * bn.weight.float()
    k = conv.weight.float() * inv.reshape(-1, 1, 1, 1)
    b = (conv.bias.float() - bn.running_mean.float()) * inv + bn.bias.float()
    return k.to(compute_dtype), b.to(compute_dtype)


def _conv(x, kernel, bias, stride=1, padding="SAME", relu=False):
    y = conv2d_nhwc(x, kernel, stride, padding) + bias
    return torch.relu(y) if relu else y


def resnet_fast_apply(module: nn.Module, x: torch.Tensor,
                      include_top: bool = False,
                      pooling: Optional[str] = "avg",
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Inference-only ResNet v1 forward over a ``ResNet`` module's tensors
    (its ``stack_sizes``); mirrors ``models/resnet.py`` (stem pad + 7×7
    "VALID", stride 2 on the first 1×1 of downsampling blocks, keras BN
    eps)."""
    x = x.to(compute_dtype)
    k, b = _folded(module.conv1_conv, module.conv1_bn, compute_dtype)
    x = _conv(pad2d(x, 3), k, b, stride=2, padding="VALID", relu=True)
    x = max_pool(pad2d(x, 1), 3, 2)

    for block in module.blocks():
        if block.conv_shortcut:
            # downsampling block: the shortcut conv_0 (4F) and the main
            # conv_1 (F) as one conv: same input, kernel and stride
            k0, b0 = _folded(block.conv_0, block.bn_0, compute_dtype)
            k1, b1 = _folded(block.conv_1, block.bn_1, compute_dtype)
            wide = _conv(x, torch.cat([k0, k1], dim=0),
                         torch.cat([b0, b1], dim=0),
                         stride=block.conv_1.stride)
            n0 = k0.shape[0]
            shortcut = wide[..., :n0]
            y = torch.relu(wide[..., n0:])
        else:
            shortcut = x
            k1, b1 = _folded(block.conv_1, block.bn_1, compute_dtype)
            y = _conv(x, k1, b1, relu=True)
        k2, b2 = _folded(block.conv_2, block.bn_2, compute_dtype)
        y = _conv(y, k2, b2, relu=True)
        k3, b3 = _folded(block.conv_3, block.bn_3, compute_dtype)
        y = _conv(y, k3, b3)
        x = torch.relu(shortcut + y)

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
