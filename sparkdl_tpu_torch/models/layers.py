"""Building blocks of the ported model zoo, in the reference's semantics.

A port of ``sparkdl_tpu.models.layers``: the blocks of the Flax-native
model zoo (Xception, InceptionV3, ResNet, VGG, MobileNetV2, TestNet).
Activations are NHWC throughout, as in the JAX package; each conv views
them as NCHW (channels-last memory) for ``F.conv2d``. Weights use
PyTorch's layouts (``models/convert.py`` maps the Flax tree onto them).
Each layer computes in the promoted type of its input and weights, as a
Flax layer computes in ``result_type(input, weights)``, unless it is given
a compute ``dtype``, as a Flax layer's ``dtype``: then each op casts its
input and its float32 weights to that dtype, and a BN with float32
statistics computes in float32 and rounds its result to the dtype once
(``flax.linen.BatchNorm``'s promotion). The parameters stay float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.core import kernels

KERAS_BN_EPS = 1e-3          # keras BatchNormalization default
RESNET_BN_EPS = 1.001e-5     # keras resnet.py blocks


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding along one axis: (before, after). The total is
    split with the extra cell AFTER, so it is asymmetric when odd (e.g. a
    3×3 stride-2 window over 74 pads 0 before and 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Conv on NHWC activations, "VALID" or XLA "SAME" padding; weight
    (Cout, Cin/groups, kh, kw) and, with ``bias``, a bias (Cout,) added
    in the conv's dtype (``flax.linen.Conv(use_bias=True)``); computes in
    ``dtype`` (None: the promoted type of input and weight)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1,
                 padding: str = "SAME", groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight``: this layer's weight as its caller already read it
        (an int8 model's layer dequantizes at each read)."""
        w = self.weight if weight is None else weight
        dtype = self.dtype or torch.promote_types(x.dtype, w.dtype)
        y = conv2d_nhwc(x.to(dtype), w.to(dtype), self.stride, self.padding,
                        self.groups)
        return y if self.bias is None else y + self.bias.to(dtype)


def pad2d(x: torch.Tensor, pad) -> torch.Tensor:
    """Keras ``ZeroPadding2D`` on NHWC: ``pad`` is an int, or ((top,
    bottom), (left, right))."""
    if isinstance(pad, int):
        pad = ((pad, pad), (pad, pad))
    (t, b), (l, r) = pad
    return F.pad(x, (0, 0, l, r, t, b))


def correct_pad(x: torch.Tensor, kernel_size: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Keras ``imagenet_utils.correct_pad`` for a stride-2 "VALID" conv on
    NHWC: one cell less before along an even axis."""
    h, w = x.shape[1], x.shape[2]
    adjust = (1 - h % 2, 1 - w % 2)
    correct = kernel_size // 2
    return ((correct - adjust[0], correct), (correct - adjust[1], correct))


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1),
                padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on NHWC activations with "VALID" or XLA "SAME"
    padding; weight (Cout, Cin/groups, kh, kw), both of one dtype."""
    kh, kw = weight.shape[2:]
    stride = _pair(stride)
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[1], kh, stride[0]),
                          same_pads(x.shape[2], kw, stride[1]))
        if t or b or l or r:
            xn = F.pad(xn, (l, r, t, b))
    y = F.conv2d(xn, weight, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, ``flax.linen.BatchNorm``'s.

    Inference (the default, as a Flax module's ``train`` defaults to
    False: a fresh layer starts in eval mode, ``module.train()`` switches
    it) uses the running statistics, in the reference's op order
    ``(x − mean)·(γ·rsqrt(var + eps)) + β``, NOT the folded affine (that
    belongs to the kernel route only).

    Training (``use_running_average=False``) takes the batch's mean and
    variance over every axis but the last, in float32 at least
    (``_compute_stats``): the "fast" biased variance ``E[x²] − E[x]²``,
    clipped at 0; the same op order then normalizes with them, and the
    running statistics move to ``m·ra + (1 − m)·batch`` with this layer's
    ``momentum``. (``F.batch_norm(training=True)`` would move the running
    variance by the UNBIASED variance, and its ``momentum`` is 1 − m.)

    The arithmetic runs in the promoted type of the input, statistics and
    γ/β; the result is rounded once to ``dtype`` where one is given, else
    to the promoted type of input, γ and β, the statistics left out
    (Flax's ``canonicalize_dtype(x, scale, bias)``): bf16 parameters over
    float32 statistics give a bf16 result, as under mixed precision."""

    def __init__(self, channels: int, eps: float = KERAS_BN_EPS,
                 scale: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.99) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.momentum = momentum
        self.weight = (nn.Parameter(torch.ones(channels)) if scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.training = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        out = self.bias.dtype if self.dtype is None else self.dtype
        if self.weight is not None:
            mul = mul * self.weight
            if self.dtype is None:
                out = torch.promote_types(out, self.weight.dtype)
        y = (x - mean) * mul + self.bias
        if self.dtype is None:
            out = torch.promote_types(out, x.dtype)
        return y.to(out)


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last, in float32
    at least: flax's ``_compute_stats`` with ``use_fast_variance``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    mean2 = (xf * xf).mean(dim=axes)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(padding="SAME")`` on NHWC: pads with −inf by XLA's
    split (see :func:`same_pads`), then a VALID max pool."""
    t, b = same_pads(x.shape[1], window, stride)
    l, r = same_pads(x.shape[2], window, stride)
    xn = x.permute(0, 3, 1, 2)
    if t or b or l or r:
        xn = F.pad(xn, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xn, window, stride).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(padding="VALID")`` on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


def avg_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 1) -> torch.Tensor:
    """Keras ``AveragePooling2D(padding="same")`` on NHWC: each window's
    sum over its valid (non-pad) cells divided by their count. With an odd
    window at stride 1, XLA's SAME split is symmetric, which is what
    ``F.avg_pool2d(count_include_pad=False)`` pads."""
    (t, b), (l, r) = (same_pads(x.shape[1], window, stride),
                      same_pads(x.shape[2], window, stride))
    if (t, l) != (b, r):
        raise ValueError(
            f"avg_pool_same: window {window}, stride {stride} pads "
            f"asymmetrically ({t}, {b}), ({l}, {r})")
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=(t, l),
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class ConvBN(nn.Module):
    """Conv2D(use_bias=False) + BatchNorm without γ (eps 1e-3) + optional
    ReLU: the InceptionV3 unit.

    ``kernel_family`` opts the unit into the fused ``pw1x1`` route
    (``core/kernels.py``): at inference, a 1×1 stride-1 "SAME" unit runs
    as one kernel launch where the kernel gate routes its site; every
    other unit runs the plain body, the route on operands of ``dtype``."""

    def __init__(self, cin: int, features: int, kernel, strides=(1, 1),
                 padding: str = "SAME", act: bool = True,
                 kernel_family: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.kernel = _pair(kernel)
        self.strides = _pair(strides)
        self.padding = padding
        self.act = act
        self.kernel_family = kernel_family
        self.dtype = dtype
        self.conv = Conv2d(cin, features, self.kernel, self.strides, padding,
                           dtype=dtype)
        self.bn = BatchNorm(features, scale=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.conv.weight  # one read: an int8 layer dequantizes
        fused = self._fused(x, weight)
        if fused is not None:
            return fused
        y = self.bn(self.conv(x, weight))
        return torch.relu(y) if self.act else y

    def _fused(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
        if self.training or self.kernel_family is None:
            return None
        if (self.strides != (1, 1) or self.kernel != (1, 1)
                or self.padding != "SAME"):
            return None
        if self.dtype is not None:
            x = x.to(self.dtype)
        return kernels.route_pw1x1(
            x, self.conv.weight if weight is None else weight,
            self.bn.weight, self.bn.bias, self.bn.running_mean,
            self.bn.running_var, self.bn.eps,
            relu=self.act, family=self.kernel_family)


class SeparableConvBN(nn.Module):
    """SeparableConv2D(use_bias=False) + BatchNorm (the Xception unit):
    depthwise (groups = Cin) then pointwise 1×1, then BN.

    ``kernel_family`` opts the unit into the fused ``sep2d`` route
    (``core/kernels.py``): at inference, a 3×3 stride-1 unit runs as one
    kernel launch where the kernel gate routes its site; otherwise the
    plain body runs (the route on operands of ``dtype``)."""

    def __init__(self, cin: int, features: int, kernel=(3, 3),
                 strides=(1, 1), bn_eps: float = KERAS_BN_EPS,
                 kernel_family: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.kernel = _pair(kernel)
        self.strides = _pair(strides)
        self.kernel_family = kernel_family
        self.dtype = dtype
        self.depthwise = Conv2d(cin, cin, self.kernel, self.strides,
                                "SAME", groups=cin, dtype=dtype)
        self.pointwise = Conv2d(cin, features, 1, dtype=dtype)
        self.bn = BatchNorm(features, bn_eps, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one read each: an int8 layer dequantizes at each read
        dw, pw = self.depthwise.weight, self.pointwise.weight
        fused = self._fused(x, dw, pw)
        if fused is not None:
            return fused
        return self.bn(self.pointwise(self.depthwise(x, dw), pw))

    def _fused(self, x: torch.Tensor, dw: Optional[torch.Tensor] = None,
               pw: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        if self.training or self.kernel_family is None:
            return None
        if self.strides != (1, 1) or self.kernel != (3, 3):
            return None
        if self.dtype is not None:
            x = x.to(self.dtype)
        return kernels.route_sep2d(
            x, self.depthwise.weight if dw is None else dw,
            self.pointwise.weight if pw is None else pw, self.bn.weight,
            self.bn.bias, self.bn.running_mean, self.bn.running_var,
            self.bn.eps, family=self.kernel_family)


class Dense(nn.Module):
    """``nn.Dense``: weight (out, in), bias (out,); computes in ``dtype``
    (None: the promoted type of input and weight)."""

    def __init__(self, cin: int, cout: int,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight  # one read: an int8 layer dequantizes at each read
        dtype = self.dtype or torch.promote_types(x.dtype, w.dtype)
        return F.linear(x.to(dtype), w.to(dtype), self.bias.to(dtype))


def classifier_head(x: torch.Tensor, dense: Dense,
                    activation: Optional[str]) -> torch.Tensor:
    x = dense(x)
    if activation == "softmax":
        x = torch.softmax(x, dim=-1)
    return x


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in, where fan_in = Cin/groups · kh · kw (or Dense's ``in``)."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
