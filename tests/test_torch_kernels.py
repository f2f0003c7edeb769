"""The port's kernel modules against the JAX package's Pallas kernels.

``sparkdl_tpu_torch.core.kernels``' plain versions (what a wrapper runs
for a CPU tensor) are held against ``sparkdl_tpu.core.kernels``' Pallas
kernels in interpret mode and their XLA twins, on the same numpy inputs.

Tolerances:
- float32: max|Δ| ≤ 1e-5·max(1, max|ref|) — the sums run in another order
  (and with or without FMA contraction) in the two frameworks;
- bfloat16 sep2d and pw1x1: max|Δ| ≤ 0.05, the JAX package's
  ``BF16_TOLERANCE``; the Pallas depthwise rounds each tap to bf16 while
  the port rounds the f32 sum once, and the XLA twins run BN in bf16;
- bfloat16 preproc: max|Δ| ≤ 2.0 — the outputs live on the uint8 [0, 255]
  scale, where one bf16 ulp is 1.0 (the JAX package's own preproc bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.core import kernels as jk
from sparkdl_tpu_torch.core import kernels as tk

F32_RTOL = 1e-5
BF16_ATOL = jk.BF16_TOLERANCE
PREPROC_BF16_ATOL = 2.0
EPS = 1e-3


def _f32_bound(ref: np.ndarray) -> float:
    return F32_RTOL * max(1.0, float(np.max(np.abs(ref))))


def _sep2d_operands(b, h, w, cin, cout):
    """Drawn as ``sparkdl_tpu.core.kernels._build_shootout`` draws them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    gamma = (np.abs(rng.normal(size=cout)) + 0.5).astype(np.float32)
    beta = (rng.normal(size=cout) * 0.1).astype(np.float32)
    mean = (rng.normal(size=cout) * 0.1).astype(np.float32)
    var = (np.abs(rng.normal(size=cout)) + 1.0).astype(np.float32)
    dw = (rng.normal(size=(3, 3, 1, cin)) * 0.2).astype(np.float32)
    pw = (rng.normal(size=(1, 1, cin, cout))
          * (1.0 / np.sqrt(cin))).astype(np.float32)
    return x, dw, pw, gamma, beta, mean, var


def _t(a, dtype):
    """numpy (possibly jax bf16) → torch tensor of ``dtype``."""
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sep2d_matches_pallas_and_xla(dtype, relu_in):
    b, h, w, cin, cout = 2, 7, 9, 16, 24
    x, dw, pw, gamma, beta, mean, var = _sep2d_operands(b, h, w, cin, cout)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    xj, dwj, pwj = (jnp.asarray(a, jdt) for a in (x, dw, pw))
    scale, shift = jk._fold_bn(jnp.asarray(gamma), jnp.asarray(beta),
                               jnp.asarray(mean), jnp.asarray(var), EPS, cout)
    pallas = jk.sep2d(xj, dwj.reshape(9, cin), pwj.reshape(cin, cout),
                      scale, shift, relu_in=relu_in, interpret=True)
    twin = jk.xla_sep2d(xj, dwj, pwj, *(jnp.asarray(a, jdt) for a in
                                        (gamma, beta, mean, var)),
                        EPS, relu_in=relu_in)
    ours = tk.plain_sep2d(_t(xj, tdt), _t(dwj.reshape(9, cin), tdt),
                          _t(pwj.reshape(cin, cout), tdt),
                          torch.from_numpy(np.array(scale)),
                          torch.from_numpy(np.array(shift)),
                          relu_in=relu_in)
    assert ours.dtype == tdt and tuple(ours.shape) == (b, h, w, cout)
    for ref in (pallas, twin):
        ref = _np32(ref)
        err = float(np.max(np.abs(_np32(ours) - ref)))
        bound = _f32_bound(ref) if dtype == "float32" else BF16_ATOL
        assert err <= bound, (err, bound)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pw1x1_matches_pallas_and_xla(dtype, relu):
    """2×5×7 = 70 rows: ragged against every row block of both kernels."""
    b, h, w, cin, cout = 2, 5, 7, 16, 24
    x, _, pw, gamma, beta, mean, var = _sep2d_operands(b, h, w, cin, cout)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    xj, pwj = jnp.asarray(x, jdt), jnp.asarray(pw, jdt)
    scale, shift = jk._fold_bn(jnp.asarray(gamma), jnp.asarray(beta),
                               jnp.asarray(mean), jnp.asarray(var), EPS, cout)
    pallas = jk.pw1x1(xj, pwj.reshape(cin, cout), scale, shift, relu=relu,
                      interpret=True)
    twin = jk.xla_pw1x1(xj, pwj, *(jnp.asarray(a, jdt) for a in
                                   (gamma, beta, mean, var)),
                        EPS, relu=relu)
    ours = tk.plain_pw1x1(_t(xj, tdt), _t(pwj.reshape(cin, cout), tdt),
                          torch.from_numpy(np.array(scale)),
                          torch.from_numpy(np.array(shift)), relu=relu)
    assert ours.dtype == tdt and tuple(ours.shape) == (b, h, w, cout)
    if relu:
        assert float(ours.float().min()) == 0.0
    for ref in (pallas, twin):
        ref = _np32(ref)
        err = float(np.max(np.abs(_np32(ours) - ref)))
        bound = _f32_bound(ref) if dtype == "float32" else BF16_ATOL
        assert err <= bound, (err, bound)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src,dst", [((13, 17), (29, 23)),
                                     ((40, 36), (32, 32))])
def test_plain_preproc_matches_pallas_and_xla(src, dst, out_dtype):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(2, *src, 3)).astype(np.uint8)
    pallas = jk.preproc_resize(jnp.asarray(x), dst, out_dtype,
                               interpret=True)
    twin = jk.xla_preproc(jnp.asarray(x), dst, out_dtype)
    ours = tk.plain_preproc(torch.from_numpy(x), dst,
                            getattr(torch, out_dtype))
    assert tuple(ours.shape) == (2, *dst, 3)
    assert ours.dtype == getattr(torch, out_dtype)
    for ref in (pallas, twin):
        ref = _np32(ref)
        err = float(np.max(np.abs(_np32(ours) - ref)))
        bound = (_f32_bound(ref) if out_dtype == "float32"
                 else PREPROC_BF16_ATOL)
        assert err <= bound, (err, bound)


def test_resize_taps_reproduce_the_matrix():
    """The kernel's two taps per row rebuild ``_resize_matrix`` exactly,
    edge clamping included, for an upscale and a downscale."""
    for src, dst in ((13, 29), (17, 23), (40, 32), (256, 299), (512, 299)):
        m = tk._resize_matrix(src, dst)
        np.testing.assert_array_equal(m, jk._resize_matrix(src, dst))
        idx, wgt = tk._resize_taps(src, dst)
        rebuilt = np.zeros_like(m)
        for t in range(dst):
            rebuilt[t, idx[t, 0]] += wgt[t, 0]
            if idx[t, 1] != idx[t, 0]:
                rebuilt[t, idx[t, 1]] += wgt[t, 1]
        np.testing.assert_array_equal(rebuilt, m)


def test_routes_on_cpu_take_the_plain_version_and_never_count(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    tk.reset_launches()
    b, h, w, cin, cout = 2, 5, 6, 8, 12
    x, dw, pw, gamma, beta, mean, var = _sep2d_operands(b, h, w, cin, cout)
    dw_t = torch.from_numpy(dw.transpose(3, 2, 0, 1).copy())   # (C,1,3,3)
    pw_t = torch.from_numpy(pw.transpose(3, 2, 0, 1).copy())   # (O,I,1,1)
    g, be, m, v = (torch.from_numpy(a) for a in (gamma, beta, mean, var))
    routed = tk.route_sep2d(torch.from_numpy(x), dw_t, pw_t, g, be, m, v,
                            EPS, family="unit")
    scale, shift = tk._fold_bn(g, be, m, v, EPS)
    plain = tk.plain_sep2d(torch.from_numpy(x),
                           torch.from_numpy(dw.reshape(9, cin)),
                           torch.from_numpy(pw.reshape(cin, cout)),
                           scale, shift)
    assert torch.equal(routed, plain)
    routed = tk.route_pw1x1(torch.from_numpy(x), pw_t, None, be, m, v, EPS,
                            relu=True, family="unit")
    scale, shift = tk._fold_bn(None, be, m, v, EPS)
    plain = tk.plain_pw1x1(torch.from_numpy(x),
                           torch.from_numpy(pw.reshape(cin, cout)), scale,
                           shift, relu=True)
    assert torch.equal(routed, plain)
    img = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (1, 9, 7, 3),
                                          dtype=np.uint8))
    resized = tk.route_preproc(img, (11, 5), torch.float32, family="unit")
    assert torch.equal(resized, tk.plain_preproc(img, (11, 5),
                                                 torch.float32))
    assert tk.launches == {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tk.preproc_resize(x, (2, 2), torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        tk.sep2d(x, torch.zeros(9, 3), torch.zeros(3, 4), torch.zeros(4),
                 torch.zeros(4))
    with pytest.raises(ValueError, match="not supported"):
        tk.pw1x1(x, torch.zeros(3, 4), torch.zeros(4), torch.zeros(4))
