"""The port's hand-written kernels, their plain versions and their routes.

The three Pallas kernels of the JAX package (``sparkdl_tpu/core/kernels.py``)
that run on a user path are CUDA C++ kernels for Hopper here (``csrc/``,
built by :mod:`.cuda_build`):

- :func:`sep2d` — optional ReLU → 3×3 SAME stride-1 depthwise → 1×1
  pointwise product (f32 accumulate) → folded-BN affine, with the
  depthwise result kept on chip (the Xception ``SeparableConvBN`` body);
- :func:`pw1x1` — a 1×1 stride-1 conv as one ``(B·H·W, Cin)·(Cin, Cout)``
  product (f32 accumulate) → folded-BN affine → optional ReLU (the
  InceptionV3 ``ConvBN`` body at its 1×1 SAME sites);
- :func:`preproc_resize` — cast + bilinear resize (half-pixel centres, no
  antialias, edge-clamped) of an NHWC batch (the fused-preprocess
  prologue of ``ModelFunction.resized``).

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version (:func:`plain_sep2d`, :func:`plain_pw1x1`,
:func:`plain_preproc`) only for a tensor on the CPU; there is no fallback
on the card. :data:`launches` counts kernel launches, one per wrapper
call that reached the card.

Models call the ``route_*`` entry points, which follow the JAX package's
``"force"`` mode: every eligible site routes. The TPU's VMEM budgets
(``_sep2d_geometry``, ``_pw1x1_geometry``, ``_preproc_geometry``) are not
limits of the function and are dropped; the accept-if-faster gate is not
ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.core import cuda_build

#: bf16 numeric contract (max |kernel − plain| per element), the JAX
#: package's ``BF16_TOLERANCE``.
BF16_TOLERANCE = 0.05

#: Kernel launches on the card since the last :func:`reset_launches`.
launches: Dict[str, int] = {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(x: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: tensors on {x.device} are not supported")


def _check(t: torch.Tensor, name: str, device: torch.device,
           dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# sep2d
# ---------------------------------------------------------------------------


def plain_sep2d(x, dw9, pw, scale, shift, *, relu_in: bool = False):
    """Plain PyTorch version of :func:`sep2d`, with the kernel's roundings:
    the depthwise sums in float32 and rounds to x's type, the pointwise
    product accumulates in float32, the affine runs in float32 and the
    result is stored in x's type."""
    cin, cout = x.shape[-1], pw.shape[-1]
    if relu_in:
        x = torch.relu(x)
    w = dw9.float().t().reshape(cin, 1, 3, 3)
    t = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1, groups=cin)
    t = t.permute(0, 2, 3, 1).to(x.dtype).float()
    y = torch.matmul(t, pw.float())
    y = y * scale.reshape(cout) + shift.reshape(cout)
    return y.to(x.dtype).contiguous()


def sep2d(x, dw9, pw, scale, shift, *, relu_in: bool = False):
    """Fused relu? → 3×3 SAME stride-1 depthwise → 1×1 pointwise → affine:
    ``(B, H, W, Cin) → (B, H, W, Cout)`` in x's type (float32 or bfloat16).

    ``dw9`` is the depthwise kernel as (9, Cin) tap-major and ``pw`` is
    (Cin, Cout), both in x's type; ``scale``/``shift`` are the folded BN
    affine, float32, (Cout,) or (1, Cout)."""
    if not _on_card(x, "sep2d"):
        return plain_sep2d(x, dw9, pw, scale, shift, relu_in=relu_in)
    if x.dim() != 4:
        raise ValueError(f"sep2d: x must be (B, H, W, Cin), got {x.shape}")
    b, h, w, cin = x.shape
    cout = pw.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sep2d: x must be float32 or bfloat16, got {x.dtype}")
    _check(x, "x", x.device, x.dtype, (b, h, w, cin))
    _check(dw9, "dw9", x.device, x.dtype, (9, cin))
    _check(pw, "pw", x.device, x.dtype, (cin, cout))
    scale, shift = scale.reshape(cout), shift.reshape(cout)
    _check(scale, "scale", x.device, torch.float32, (cout,))
    _check(shift, "shift", x.device, torch.float32, (cout,))
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _sep2d_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dw9.data_ptr(), pw.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                 b, h, w, cin, cout, int(relu_in), _DTYPE_CODES[x.dtype],
                 stream)
    _raise_on_error(err, "sep2d")
    launches["sep2d"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sep2d_fn():
    fn = cuda_build.library("sep2d").sparkdl_sep2d
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fold_bn(gamma, beta, mean, var, eps: float):
    """BN → per-channel float32 affine: scale = γ·rsqrt(var + eps),
    shift = β − mean·scale, each (Cout,), for the kernel epilogue."""
    scale = torch.rsqrt(var.float() + eps)
    if gamma is not None:
        scale = scale * gamma.float()
    shift = beta.float() - mean.float() * scale
    return scale.contiguous(), shift.contiguous()


# ---------------------------------------------------------------------------
# pw1x1
# ---------------------------------------------------------------------------


def plain_pw1x1(x, w2, scale, shift, *, relu: bool = False):
    """Plain PyTorch version of :func:`pw1x1`: the product of the float32
    upcasts, the affine and ReLU in float32, the result in x's type."""
    cout = w2.shape[-1]
    y = torch.matmul(x.float(), w2.float())
    y = y * scale.reshape(cout) + shift.reshape(cout)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def pw1x1(x, w2, scale, shift, *, relu: bool = False):
    """Fused 1×1 conv (one product over the flattened positions) → affine
    → optional ReLU: ``(B, H, W, Cin) → (B, H, W, Cout)`` in x's type
    (float32 or bfloat16).

    ``w2`` is (Cin, Cout) in x's type; ``scale``/``shift`` are the folded
    BN affine, float32, (Cout,) or (1, Cout)."""
    if not _on_card(x, "pw1x1"):
        return plain_pw1x1(x, w2, scale, shift, relu=relu)
    if x.dim() != 4:
        raise ValueError(f"pw1x1: x must be (B, H, W, Cin), got {x.shape}")
    b, h, w, cin = x.shape
    cout = w2.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pw1x1: x must be float32 or bfloat16, got {x.dtype}")
    _check(x, "x", x.device, x.dtype, (b, h, w, cin))
    _check(w2, "w2", x.device, x.dtype, (cin, cout))
    scale, shift = scale.reshape(cout), shift.reshape(cout)
    _check(scale, "scale", x.device, torch.float32, (cout,))
    _check(shift, "shift", x.device, torch.float32, (cout,))
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _pw1x1_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w2.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), out.data_ptr(), b * h * w, cin, cout,
                 int(relu), _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(err, "pw1x1")
    launches["pw1x1"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _pw1x1_fn():
    fn = cuda_build.library("pw1x1").sparkdl_pw1x1
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# preproc_resize
# ---------------------------------------------------------------------------


def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation weights reproducing
    ``jax.image.resize(method="bilinear", antialias=False)``: half-pixel
    centres (src coord = (t + 0.5)·src/dst − 0.5), triangle kernel,
    edge-clamped; two taps clamped onto one index add their weights."""
    scale = src / dst
    out = np.zeros((dst, src), np.float32)
    for t in range(dst):
        s = (t + 0.5) * scale - 0.5
        lo = int(np.floor(s))
        frac = s - lo
        for tap, wgt in ((lo, 1.0 - frac), (lo + 1, frac)):
            out[t, min(max(tap, 0), src - 1)] += wgt
    return out


@functools.lru_cache(maxsize=64)
def _resize_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two taps of each row of :func:`_resize_matrix`: indices (dst, 2)
    int32 ascending and weights (dst, 2) float32 (an unused second tap
    repeats the first index with weight 0)."""
    m = _resize_matrix(src, dst)
    idx = np.zeros((dst, 2), np.int32)
    wgt = np.zeros((dst, 2), np.float32)
    for t in range(dst):
        nz = np.nonzero(m[t])[0]
        if len(nz) > 2:
            raise AssertionError("a bilinear row has at most two taps")
        idx[t] = (nz[0], nz[-1])
        wgt[t, 0] = m[t, nz[0]]
        if len(nz) == 2:
            wgt[t, 1] = m[t, nz[1]]
    return idx, wgt


_device_taps_cache: Dict[Tuple[int, int, str], Tuple[torch.Tensor,
                                                      torch.Tensor]] = {}


def _device_taps(src: int, dst: int, device: torch.device):
    key = (src, dst, str(device))
    taps = _device_taps_cache.get(key)
    if taps is None:
        idx, wgt = _resize_taps(src, dst)
        taps = (torch.from_numpy(idx).to(device),
                torch.from_numpy(wgt).to(device))
        _device_taps_cache[key] = taps
    return taps


def plain_preproc(x, target_hw: Tuple[int, int], out_dtype):
    """Plain PyTorch version of :func:`preproc_resize`: cast to float32,
    then the two :func:`_resize_matrix` products (``Wh·X`` then ``·Wwᵀ``)
    per (image, channel) plane, then cast to ``out_dtype``."""
    _, h, w, _ = x.shape
    th, tw = int(target_hw[0]), int(target_hw[1])
    wh = torch.from_numpy(_resize_matrix(h, th)).to(x.device)
    ww = torch.from_numpy(_resize_matrix(w, tw)).to(x.device)
    t = torch.einsum("oh,bhwc->bowc", wh, x.float())
    y = torch.einsum("pw,bowc->bopc", ww, t)
    return y.to(out_dtype).contiguous()


def preproc_resize(x, target_hw: Tuple[int, int], out_dtype):
    """Fused cast + bilinear resize: ``(B, H, W, C)`` uint8, float32 or
    bfloat16 → ``(B, th, tw, C)`` in ``out_dtype`` (float32/bfloat16)."""
    if not _on_card(x, "preproc_resize"):
        return plain_preproc(x, target_hw, out_dtype)
    if x.dim() != 4:
        raise ValueError(
            f"preproc_resize: x must be (B, H, W, C), got {x.shape}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"preproc_resize: unsupported input dtype {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"preproc_resize: out_dtype must be float32 or bfloat16, got "
            f"{out_dtype}")
    b, h, w, c = x.shape
    th, tw = int(target_hw[0]), int(target_hw[1])
    _check(x, "x", x.device, x.dtype, (b, h, w, c))
    ytap, ywt = _device_taps(h, th, x.device)
    xtap, xwt = _device_taps(w, tw, x.device)
    out = torch.empty((b, th, tw, c), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _preproc_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), ytap.data_ptr(),
                 ywt.data_ptr(), xtap.data_ptr(), xwt.data_ptr(),
                 b, h, w, c, th, tw, _DTYPE_CODES[x.dtype],
                 _DTYPE_CODES[out_dtype], stream)
    _raise_on_error(err, "preproc_resize")
    launches["preproc_resize"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _preproc_fn():
    fn = cuda_build.library("preproc_resize").sparkdl_preproc_resize
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Routes — the only entry points models use
# ---------------------------------------------------------------------------


def route_sep2d(x, dw_weight, pw_weight, bn_weight, bn_bias, bn_mean,
                bn_var, eps: float, *, relu_in: bool = False):
    """The fused sepconv body for one site. Weights are in the port's
    layout: depthwise (Cin, 1, 3, 3), pointwise (Cout, Cin, 1, 1); they
    are cast to x's type as the JAX route does."""
    cin = x.shape[-1]
    cout = pw_weight.shape[0]
    dw9 = dw_weight.reshape(cin, 9).t().to(x.dtype).contiguous()
    pw2 = pw_weight.reshape(cout, cin).t().to(x.dtype).contiguous()
    scale, shift = _fold_bn(bn_weight, bn_bias, bn_mean, bn_var, eps)
    return sep2d(x.contiguous(), dw9, pw2, scale, shift, relu_in=relu_in)


def route_pw1x1(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                eps: float, *, relu: bool):
    """The fused 1×1 ConvBN body for one site. The conv weight is in the
    port's layout, (Cout, Cin, 1, 1); it is cast to x's type as the JAX
    route does."""
    cin = x.shape[-1]
    cout = conv_weight.shape[0]
    w2 = conv_weight.reshape(cout, cin).t().to(x.dtype).contiguous()
    scale, shift = _fold_bn(bn_weight, bn_bias, bn_mean, bn_var, eps)
    return pw1x1(x.contiguous(), w2, scale, shift, relu=relu)


def route_preproc(x, target_hw: Tuple[int, int], out_dtype):
    """The fused cast + resize prologue for one resize."""
    return preproc_resize(x.contiguous(), target_hw, out_dtype)

