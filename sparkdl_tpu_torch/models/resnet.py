"""ResNet50/101/152 (v1) — keras.applications.resnet parity, ported from
``sparkdl_tpu.models.resnet``.

224×224 input, caffe-style preprocessing, 2048-d features (global
average pool). As the reference: BN with γ and eps 1.001e-5 after every
biased conv; the stem pads 3 cells and runs a 7×7 "VALID" stride-2 conv,
then pads 1 cell of zeros before a 3×3/2 "VALID" max pool; a
downsampling block puts its stride on the FIRST 1×1 (``conv_1``) and on
the shortcut ``conv_0``, not on the 3×3. Submodule names are the Flax
module's; ``dtype`` is every layer's compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    RESNET_BN_EPS, BatchNorm, Conv2d, Dense, classifier_head,
    global_avg_pool, max_pool, pad2d,
)

FILTERS = (64, 128, 256, 512)


class ResidualBlockV1(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 conv_shortcut: bool = True,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.conv_shortcut = conv_shortcut

        def conv(name, c_in, c_out, kernel, s=1):
            self.add_module(name, Conv2d(c_in, c_out, kernel, s, bias=True,
                                         dtype=dtype))
            self.add_module(name.replace("conv", "bn"),
                            BatchNorm(c_out, RESNET_BN_EPS, dtype=dtype))

        if conv_shortcut:
            conv("conv_0", cin, 4 * filters, 1, stride)
        conv("conv_1", cin, filters, 1, stride)
        conv("conv_2", filters, filters, 3)
        conv("conv_3", filters, 4 * filters, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.bn_0(self.conv_0(x)) if self.conv_shortcut else x
        y = torch.relu(self.bn_1(self.conv_1(x)))
        y = torch.relu(self.bn_2(self.conv_2(y)))
        y = self.bn_3(self.conv_3(y))
        return torch.relu(shortcut + y)


class ResNet(nn.Module):
    """ResNet v1 family. ``stack_sizes``: blocks per stage."""

    def __init__(self, stack_sizes: Sequence[int] = (3, 4, 6, 3),
                 include_top: bool = True, classes: int = 1000,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = "avg",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.stack_sizes = tuple(stack_sizes)
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling
        self.conv1_conv = Conv2d(3, 64, 7, stride=2, padding="VALID",
                                 bias=True, dtype=dtype)
        self.conv1_bn = BatchNorm(64, RESNET_BN_EPS, dtype=dtype)
        cin = 64
        for stage, (f, blocks) in enumerate(zip(FILTERS, self.stack_sizes)):
            for i in range(1, blocks + 1):
                self.add_module(f"conv{stage + 2}_block{i}", ResidualBlockV1(
                    cin, f, stride=1 if stage == 0 or i > 1 else 2,
                    conv_shortcut=i == 1, dtype=dtype))
                cin = 4 * f
        if include_top:
            self.predictions = Dense(cin, classes, dtype=dtype)

    def blocks(self):
        """The residual blocks in call order."""
        for stage, blocks in enumerate(self.stack_sizes):
            for i in range(1, blocks + 1):
                yield self._modules[f"conv{stage + 2}_block{i}"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad2d(x, 3)
        x = torch.relu(self.conv1_bn(self.conv1_conv(x)))
        x = max_pool(pad2d(x, 1), 3, 2)
        for block in self.blocks():
            x = block(x)
        if self.include_top:
            return classifier_head(global_avg_pool(x), self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stack_sizes=(3, 4, 6, 3), **kwargs)


def ResNet101(**kwargs) -> ResNet:
    return ResNet(stack_sizes=(3, 4, 23, 3), **kwargs)


def ResNet152(**kwargs) -> ResNet:
    return ResNet(stack_sizes=(3, 8, 36, 3), **kwargs)
