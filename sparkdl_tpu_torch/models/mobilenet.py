"""MobileNetV2 — keras.applications.mobilenet_v2 parity, ported from
``sparkdl_tpu.models.mobilenet``.

224×224 input, [-1, 1] preprocessing, 1280-d features. Inverted residual
blocks per the Keras table, BN eps 1e-3, ReLU6. As the reference: block 0
has no expand conv; a stride-2 depthwise pads by Keras's ``correct_pad``
and runs "VALID" (not "SAME": the pads differ); ``Conv1`` is a "SAME"
stride-2 conv, whose pad XLA splits asymmetrically (``same_pads``); the
residual is taken only where the block keeps its width at stride 1; the
last conv is 1280 wide at α ≤ 1. Submodule names are the Flax module's;
``dtype`` is every layer's compute dtype. The depthwise convs are plain
grouped ``F.conv2d``, as the reference's are XLA convs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Dense, classifier_head, correct_pad, global_avg_pool,
    pad2d,
)

MNV2_BN_EPS = 1e-3
MNV2_BN_MOMENTUM = 0.999  # the reference's (mobilenet.py)

# (filters, stride, expansion) per block, keras order.
MNV2_BLOCKS = (
    (16, 1, 1),
    (24, 2, 6), (24, 1, 6),
    (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
    (96, 1, 6), (96, 1, 6), (96, 1, 6),
    (160, 2, 6), (160, 1, 6), (160, 1, 6),
    (320, 1, 6),
)


def _make_divisible(v: float, divisor: int = 8,
                    min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


class InvertedResBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, expansion: int,
                 alpha: float = 1.0, block_id: int = 0,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.stride = stride
        self.block_id = block_id
        pointwise = _make_divisible(int(filters * alpha))
        self.residual = cin == pointwise and stride == 1
        ch = cin
        if block_id:
            ch = expansion * cin
            self.expand = Conv2d(cin, ch, 1, dtype=dtype)
            self.expand_bn = BatchNorm(ch, MNV2_BN_EPS, dtype=dtype,
                                       momentum=MNV2_BN_MOMENTUM)
        self.depthwise = Conv2d(ch, ch, 3, stride,
                                "VALID" if stride == 2 else "SAME",
                                groups=ch, dtype=dtype)
        self.depthwise_bn = BatchNorm(ch, MNV2_BN_EPS, dtype=dtype,
                                      momentum=MNV2_BN_MOMENTUM)
        self.project = Conv2d(ch, pointwise, 1, dtype=dtype)
        self.project_bn = BatchNorm(pointwise, MNV2_BN_EPS, dtype=dtype,
                                    momentum=MNV2_BN_MOMENTUM)
        self.out_channels = pointwise

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.block_id:
            x = relu6(self.expand_bn(self.expand(x)))
        if self.stride == 2:
            x = pad2d(x, correct_pad(x, 3))
        x = relu6(self.depthwise_bn(self.depthwise(x)))
        x = self.project_bn(self.project(x))
        return inputs + x if self.residual else x


class MobileNetV2(nn.Module):
    def __init__(self, alpha: float = 1.0, include_top: bool = True,
                 classes: int = 1000,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = "avg",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling
        first = _make_divisible(32 * alpha)
        self.Conv1 = Conv2d(3, first, 3, stride=2, dtype=dtype)
        self.Conv1_bn = BatchNorm(first, MNV2_BN_EPS, dtype=dtype,
                                  momentum=MNV2_BN_MOMENTUM)
        cin = first
        for bid, (f, s, e) in enumerate(MNV2_BLOCKS):
            block = InvertedResBlock(cin, f, s, e, alpha=alpha, block_id=bid,
                                     dtype=dtype)
            self.add_module(f"block_{bid}", block)
            cin = block.out_channels
        last = _make_divisible(1280 * alpha) if alpha > 1.0 else 1280
        self.Conv_1 = Conv2d(cin, last, 1, dtype=dtype)
        self.Conv_1_bn = BatchNorm(last, MNV2_BN_EPS, dtype=dtype,
                                   momentum=MNV2_BN_MOMENTUM)
        if include_top:
            self.predictions = Dense(last, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu6(self.Conv1_bn(self.Conv1(x)))
        for bid in range(len(MNV2_BLOCKS)):
            x = self._modules[f"block_{bid}"](x)
        x = relu6(self.Conv_1_bn(self.Conv_1(x)))
        if self.include_top:
            return classifier_head(global_avg_pool(x), self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x
