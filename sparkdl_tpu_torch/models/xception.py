"""Xception — keras.applications.xception parity, ported from
``sparkdl_tpu.models.xception``.

299×299 input, [-1, 1] preprocessing, 2048-d features. Entry flow
(blocks 1-4), middle flow (blocks 5-12, 728 channels), exit flow (blocks
13-14). Submodule names are the Flax module's, so its variables map onto
this state dict one to one (``models/convert.py``). ``dtype`` is every
layer's compute dtype, as the Flax module's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Dense, SeparableConvBN, classifier_head,
    global_avg_pool, max_pool_same,
)


class Xception(nn.Module):
    def __init__(self, include_top: bool = True, classes: int = 1000,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = "avg",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling

        def sep(name, cin, features):
            # kernel_family opts the unit into the fused sep2d route
            self.add_module(name, SeparableConvBN(
                cin, features, kernel_family="xception", dtype=dtype))

        self.block1_conv1 = Conv2d(3, 32, 3, stride=2, padding="VALID",
                                   dtype=dtype)
        self.block1_conv1_bn = BatchNorm(32, dtype=dtype)
        self.block1_conv2 = Conv2d(32, 64, 3, padding="VALID", dtype=dtype)
        self.block1_conv2_bn = BatchNorm(64, dtype=dtype)
        cin = 64
        for i, features in zip((2, 3, 4), (128, 256, 728)):
            self.add_module(f"block{i}_res_conv",
                            Conv2d(cin, features, 1, stride=2, dtype=dtype))
            self.add_module(f"block{i}_res_bn",
                            BatchNorm(features, dtype=dtype))
            sep(f"block{i}_sepconv1", cin, features)
            sep(f"block{i}_sepconv2", features, features)
            cin = features
        for i in range(5, 13):
            for j in (1, 2, 3):
                sep(f"block{i}_sepconv{j}", 728, 728)
        self.block13_res_conv = Conv2d(728, 1024, 1, stride=2, dtype=dtype)
        self.block13_res_bn = BatchNorm(1024, dtype=dtype)
        sep("block13_sepconv1", 728, 728)
        sep("block13_sepconv2", 728, 1024)
        sep("block14_sepconv1", 1024, 1536)
        sep("block14_sepconv2", 1536, 2048)
        if include_top:
            self.predictions = Dense(2048, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        x = torch.relu(self.block1_conv1_bn(self.block1_conv1(x)))
        x = torch.relu(self.block1_conv2_bn(self.block1_conv2(x)))

        for i in (2, 3, 4):
            residual = m[f"block{i}_res_bn"](m[f"block{i}_res_conv"](x))
            if i > 2:
                x = torch.relu(x)
            x = m[f"block{i}_sepconv1"](x)
            x = torch.relu(x)
            x = m[f"block{i}_sepconv2"](x)
            x = max_pool_same(x, 3, 2)
            x = x + residual

        for i in range(5, 13):
            residual = x
            for j in (1, 2, 3):
                x = torch.relu(x)
                x = m[f"block{i}_sepconv{j}"](x)
            x = x + residual

        residual = self.block13_res_bn(self.block13_res_conv(x))
        x = torch.relu(x)
        x = self.block13_sepconv1(x)
        x = torch.relu(x)
        x = self.block13_sepconv2(x)
        x = max_pool_same(x, 3, 2)
        x = x + residual

        x = self.block14_sepconv1(x)
        x = torch.relu(x)
        x = self.block14_sepconv2(x)
        x = torch.relu(x)

        if self.include_top:
            return classifier_head(global_avg_pool(x), self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x
