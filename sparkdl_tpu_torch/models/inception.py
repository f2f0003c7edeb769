"""InceptionV3 — keras.applications.inception_v3 parity, ported from
``sparkdl_tpu.models.inception``.

The reference's flagship featurizer: 299×299 input, [-1, 1]
preprocessing, 2048-d features. Every conv is a :class:`ConvBN` (no bias,
BN without γ, eps 1e-3), named ``cb0`` … ``cb93`` in call order as in the
Flax module, so its variables map onto this state dict one to one
(``models/convert.py``). The 39 units that are 1×1, stride 1 and "SAME"
run through the ``pw1x1`` kernel at inference (``ConvBN._fused``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    ConvBN, Dense, avg_pool_same, classifier_head, global_avg_pool, max_pool,
)

#: (Cin, features, kh, kw, stride, padding) of each unit, in call order.
_Unit = Tuple[int, int, int, int, int, str]


def _units() -> List[_Unit]:
    units: List[_Unit] = []

    def cb(cin, features, kh, kw, stride=1, padding="SAME"):
        units.append((cin, features, kh, kw, stride, padding))
        return features

    # Stem
    c = cb(cb(cb(3, 32, 3, 3, 2, "VALID"), 32, 3, 3, 1, "VALID"), 64, 3, 3)
    c = cb(cb(c, 80, 1, 1, 1, "VALID"), 192, 3, 3, 1, "VALID")
    # mixed 0..2: 35×35 inception-A
    for pool_features in (32, 64, 64):
        cb(c, 64, 1, 1)
        cb(cb(c, 48, 1, 1), 64, 5, 5)
        cb(cb(cb(c, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        cb(c, pool_features, 1, 1)
        c = 64 + 64 + 96 + pool_features
    # mixed 3: 17×17 reduction
    cb(c, 384, 3, 3, 2, "VALID")
    cb(cb(cb(c, 64, 1, 1), 96, 3, 3), 96, 3, 3, 2, "VALID")
    c = 384 + 96 + c
    # mixed 4..7: 17×17 inception-B (7×7 factorized)
    for c7 in (128, 160, 160, 192):
        cb(c, 192, 1, 1)
        cb(cb(cb(c, c7, 1, 1), c7, 1, 7), 192, 7, 1)
        cb(cb(cb(cb(cb(c, c7, 1, 1), c7, 7, 1), c7, 1, 7), c7, 7, 1), 192,
           1, 7)
        cb(c, 192, 1, 1)
        c = 4 * 192
    # mixed 8: 8×8 reduction
    cb(cb(c, 192, 1, 1), 320, 3, 3, 2, "VALID")
    cb(cb(cb(cb(c, 192, 1, 1), 192, 1, 7), 192, 7, 1), 192, 3, 3, 2,
       "VALID")
    c = 320 + 192 + c
    # mixed 9..10: 8×8 inception-C
    for _ in range(2):
        cb(c, 320, 1, 1)
        b3 = cb(c, 384, 1, 1)
        cb(b3, 384, 1, 3)
        cb(b3, 384, 3, 1)
        bd = cb(cb(c, 448, 1, 1), 384, 3, 3)
        cb(bd, 384, 1, 3)
        cb(bd, 384, 3, 1)
        cb(c, 192, 1, 1)
        c = 320 + 2 * 384 + 2 * 384 + 192
    return units


class InceptionV3(nn.Module):
    def __init__(self, include_top: bool = True, classes: int = 1000,
                 classifier_activation: Optional[str] = "softmax",
                 pooling: Optional[str] = "avg",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.pooling = pooling
        for i, (cin, features, kh, kw, stride, padding) in enumerate(
                _units()):
            # kernel_family opts the 1×1 SAME units into the pw1x1 route
            self.add_module(f"cb{i}", ConvBN(cin, features, (kh, kw), stride,
                                             padding,
                                             kernel_family="inception",
                                             dtype=dtype))
        if include_top:
            self.predictions = Dense(2048, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        units = (m for m in self.children() if isinstance(m, ConvBN))

        def cb(h):
            return next(units)(h)

        def cat(*parts):
            return torch.cat(parts, dim=-1)

        # Stem
        x = max_pool(cb(cb(cb(x))), 3, 2)
        x = max_pool(cb(cb(x)), 3, 2)
        # mixed 0..2
        for _ in range(3):
            b1 = cb(x)
            b5 = cb(cb(x))
            b3 = cb(cb(cb(x)))
            x = cat(b1, b5, b3, cb(avg_pool_same(x)))
        # mixed 3
        b3 = cb(x)
        bd = cb(cb(cb(x)))
        x = cat(b3, bd, max_pool(x, 3, 2))
        # mixed 4..7
        for _ in range(4):
            b1 = cb(x)
            b7 = cb(cb(cb(x)))
            bd = cb(cb(cb(cb(cb(x)))))
            x = cat(b1, b7, bd, cb(avg_pool_same(x)))
        # mixed 8
        b3 = cb(cb(x))
        b7 = cb(cb(cb(cb(x))))
        x = cat(b3, b7, max_pool(x, 3, 2))
        # mixed 9..10
        for _ in range(2):
            b1 = cb(x)
            b3 = cb(x)
            b3 = cat(cb(b3), cb(b3))
            bd = cb(cb(x))
            bd = cat(cb(bd), cb(bd))
            x = cat(b1, b3, bd, cb(avg_pool_same(x)))

        if self.include_top:
            return classifier_head(global_avg_pool(x), self.predictions,
                                   self.classifier_activation)
        if self.pooling == "avg":
            return global_avg_pool(x)
        if self.pooling == "max":
            return x.amax(dim=(1, 2))
        return x
