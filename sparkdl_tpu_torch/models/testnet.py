"""TestNet — the tiny deterministic CNN of the reference's tests, ported
from ``sparkdl_tpu.models.testnet``.

32×32 input, two stride-2 "SAME" biased 3×3 convs (8 and 16 channels),
16-d features, 10 classes. Submodule names are the Flax module's
(``models/convert.py`` maps its variables one to one); ``dtype`` is every
layer's compute dtype, as the Flax module's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    Conv2d, Dense, classifier_head, global_avg_pool,
)


class TestNet(nn.Module):
    def __init__(self, include_top: bool = True, classes: int = 10,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = "avg",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling
        self.conv1 = Conv2d(3, 8, 3, stride=2, bias=True, dtype=dtype)
        self.conv2 = Conv2d(8, 16, 3, stride=2, bias=True, dtype=dtype)
        if include_top:
            self.predictions = Dense(16, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        if self.include_top:
            return classifier_head(global_avg_pool(x), self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x
