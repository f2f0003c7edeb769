"""VGG16/VGG19 — keras.applications.vgg16/vgg19 parity, ported from
``sparkdl_tpu.models.vgg``.

224×224 input, caffe-style preprocessing. The reference's featurize
layer for VGG is fc2's 4096-d activation (``features_at_fc2``), which the
registry asks for with ``include_top=True, features_at_fc2=True``; such a
module has no ``predictions`` layer, as the Flax module creates none.
The 2×2/2 max pools are "VALID", and the flatten before ``fc1`` takes the
NHWC activations in their own order (Keras's ``Flatten``).

Flax sizes ``fc1`` from the input it first sees; a PyTorch module holds
its weights from construction, so it takes ``input_size`` (default the
registry's 224×224) to size ``fc1``'s (H/32)·(W/32)·512 inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    Conv2d, Dense, classifier_head, global_avg_pool, max_pool,
)

FILTERS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """``convs_per_block``: e.g. (2, 2, 3, 3, 3) for VGG16."""

    def __init__(self, convs_per_block: Sequence[int] = (2, 2, 3, 3, 3),
                 include_top: bool = True, classes: int = 1000,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = None,
                 features_at_fc2: bool = False,
                 input_size: Tuple[int, int] = (224, 224),
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.convs_per_block = tuple(convs_per_block)
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling
        self.features_at_fc2 = features_at_fc2
        cin = 3
        for b, (f, n) in enumerate(zip(FILTERS, self.convs_per_block), 1):
            for c in range(1, n + 1):
                self.add_module(f"block{b}_conv{c}", Conv2d(
                    cin, f, 3, bias=True, dtype=dtype))
                cin = f
        if include_top:
            h, w = input_size
            flat = (h // 32) * (w // 32) * cin
            self.fc1 = Dense(flat, 4096, dtype=dtype)
            self.fc2 = Dense(4096, 4096, dtype=dtype)
            if not features_at_fc2:
                self.predictions = Dense(4096, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        for b, n in enumerate(self.convs_per_block, 1):
            for c in range(1, n + 1):
                x = torch.relu(m[f"block{b}_conv{c}"](x))
            x = max_pool(x, 2, 2)

        if self.include_top:
            x = x.reshape(x.shape[0], -1)  # Flatten, keras order (NHWC)
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            if self.features_at_fc2:
                return x
            return classifier_head(x, self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x


def VGG16(**kwargs) -> VGG:
    return VGG(convs_per_block=(2, 2, 3, 3, 3), **kwargs)


def VGG19(**kwargs) -> VGG:
    return VGG(convs_per_block=(2, 2, 4, 4, 4), **kwargs)
