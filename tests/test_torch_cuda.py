"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip elsewhere. The machine with the
card has no JAX, so this file imports none and runs without the suite's
``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 max|Δ| ≤ 1e-5·max(1, max|ref|) (another summation
order); bf16 max|Δ| ≤ 0.05 (the JAX package's ``BF16_TOLERANCE``).
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.experiments.preproc_breakdown import exact_order

EPS = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32_bound(ref: torch.Tensor) -> float:
    return 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 9, 16, 72), (3, 5, 4, 40, 24),
                                   (1, 19, 19, 728, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu_in", [False, True])
def test_sep2d_matches_plain(card, shape, dtype, relu_in):
    b, h, w, cin, cout = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, h, w, cin, generator=gen).to(card, dtype)
    dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(card, dtype)
    pw = (torch.randn(cin, cout, generator=gen) / cin ** 0.5).to(card, dtype)
    scale = (torch.rand(cout, generator=gen) + 0.5).to(card)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(card)
    before = kernels.launches["sep2d"]
    y = kernels.sep2d(x, dw9, pw, scale, shift, relu_in=relu_in)
    torch.cuda.synchronize()
    assert kernels.launches["sep2d"] == before + 1
    ref = kernels.plain_sep2d(x, dw9, pw, scale, shift, relu_in=relu_in)
    assert y.dtype == dtype and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 7, 192, 64), (1, 17, 17, 768, 192),
                                   (2, 8, 8, 2048, 448), (3, 3, 5, 20, 36),
                                   (1, 4, 9, 37, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_pw1x1_matches_plain(card, shape, dtype, relu):
    """InceptionV3's widths, a ragged N, and widths that are not multiples
    of the 16-byte load (which take the kernel's scalar loads)."""
    b, h, w, cin, cout = shape
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(b, h, w, cin, generator=gen).to(card, dtype)
    w2 = (torch.randn(cin, cout, generator=gen) / cin ** 0.5).to(card, dtype)
    scale = (torch.rand(cout, generator=gen) * 0.5 + 0.5).to(card)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(card)
    before = kernels.launches["pw1x1"]
    y = kernels.pw1x1(x, w2, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert kernels.launches["pw1x1"] == before + 1
    ref = kernels.plain_pw1x1(x, w2, scale, shift, relu=relu)
    assert y.dtype == dtype and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


#: Xception's ten sep2d site shapes at 299×299 (H×W, Cin, Cout); the
#: model applies its ReLUs outside the route, so relu_in is off at all.
XCEPTION_SEP2D_SITES = [(147, 64, 128), (147, 128, 128), (74, 128, 256),
                        (74, 256, 256), (37, 256, 728), (37, 728, 728),
                        (19, 728, 728), (19, 728, 1024), (10, 1024, 1536),
                        (10, 1536, 2048)]
#: InceptionV3's eighteen 1×1 pw1x1 site shapes at 299×299 (H×W, Cin,
#: Cout); every one applies ReLU.
INCEPTION_PW1X1_SITES = [(35, 192, 32), (35, 192, 48), (35, 192, 64),
                         (35, 256, 48), (35, 256, 64), (35, 288, 48),
                         (35, 288, 64), (17, 768, 128), (17, 768, 160),
                         (17, 768, 192), (8, 1280, 192), (8, 1280, 320),
                         (8, 1280, 384), (8, 1280, 448), (8, 2048, 192),
                         (8, 2048, 320), (8, 2048, 384), (8, 2048, 448)]
BATCH = 16  # the featurize path's batch: the plans of the main path


def _sep2d_case(card, b, h, w, cin, cout, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen).to(card, dtype)
    dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(card, dtype)
    # (Cin, Cout) as the transpose of (Cout, Cin), the routes' layout
    pw = (torch.randn(cout, cin, generator=gen) / cin ** 0.5).to(
        card, dtype).t()
    scale = (torch.rand(cout, generator=gen) + 0.5).to(card)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(card)
    return x, dw9, pw, scale, shift


def _launched_body(kernel, fn):
    before = dict(kernels.launches_by_body[kernel])
    out = fn()
    torch.cuda.synchronize()
    ran = [b for b, n in kernels.launches_by_body[kernel].items()
           if n != before[b]]
    assert len(ran) == 1 and \
        kernels.launches_by_body[kernel][ran[0]] == before[ran[0]] + 1
    return out, ran[0]


@pytest.mark.cuda
@pytest.mark.parametrize("site", XCEPTION_SEP2D_SITES,
                         ids=lambda s: "%dx%d_%d_%d" % (s[0], s[0], *s[1:]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sep2d_at_xception_sites(card, site, dtype):
    """Each Xception site at batch 16: the kernel against its plain
    version, and the body its plan launched (the tensor-core body for
    every bf16 site)."""
    hw, cin, cout = site
    args = _sep2d_case(card, BATCH, hw, hw, cin, cout, dtype)
    y, body = _launched_body("sep2d", lambda: kernels.sep2d(*args))
    assert body == ("wgmma" if dtype == torch.bfloat16 else "simt_f32")
    assert body == kernels.plan_sep2d(BATCH, hw, hw, cin, cout, dtype).body
    ref = kernels.plain_sep2d(*args)
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sep2d_ragged_cin_takes_the_simt_body(card, dtype):
    """Cin = 20: rows TMA cannot stride, so bf16 takes its SIMT body
    (``simt_bf16``), float32 the float32 mainloop."""
    args = _sep2d_case(card, 2, 6, 5, 20, 24, dtype, seed=5)
    y, body = _launched_body("sep2d", lambda: kernels.sep2d(
        *args, relu_in=True))
    assert body == ("simt_bf16" if dtype == torch.bfloat16 else "simt_f32")
    ref = kernels.plain_sep2d(*args, relu_in=True)
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


def _pw1x1_case(card, b, h, w, cin, cout, dtype, seed=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen).to(card, dtype)
    w2 = (torch.randn(cout, cin, generator=gen) / cin ** 0.5).to(
        card, dtype).t()
    scale = (torch.rand(cout, generator=gen) * 0.5 + 0.5).to(card)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(card)
    return x, w2, scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("site", INCEPTION_PW1X1_SITES,
                         ids=lambda s: "%dx%d_%d_%d" % (s[0], s[0], *s[1:]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pw1x1_at_inception_sites(card, site, dtype):
    """Each InceptionV3 1×1 site at batch 16 with its ReLU: the kernel
    against its plain version, and the body its plan launched."""
    hw, cin, cout = site
    x, w2, scale, shift = _pw1x1_case(card, BATCH, hw, hw, cin, cout, dtype)
    y, body = _launched_body("pw1x1", lambda: kernels.pw1x1(
        x, w2, scale, shift, relu=True))
    assert body == ("wgmma" if dtype == torch.bfloat16 else "simt_f32")
    ref = kernels.plain_pw1x1(x, w2, scale, shift, relu=True)
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pw1x1_split_k(card, dtype):
    """8×8 2048→448 at batch 16: 112 (bf16) or 56 (float32) tiles, so the
    plan splits K; the shares reduce to the plain version's result (the
    float32 ones in a cluster's shared memory)."""
    plan = kernels.plan_pw1x1(BATCH * 64, 2048, 448, dtype)
    assert plan.splits > 1 and (plan.blocks >= kernels.SMS or plan.note)
    x, w2, scale, shift = _pw1x1_case(card, BATCH, 8, 8, 2048, 448, dtype,
                                      seed=9)
    y, body = _launched_body("pw1x1", lambda: kernels.pw1x1(
        x, w2, scale, shift, relu=False))
    assert body == plan.body
    ref = kernels.plain_pw1x1(x, w2, scale, shift, relu=False)
    err = float((y.float() - ref.float()).abs().max())
    assert err <= (_f32_bound(ref.float()) if dtype == torch.float32
                   else kernels.BF16_TOLERANCE), err


#: Ragged shapes of the float32 mainloop: (B, H, W, Cin, Cout). Positions
#: not a multiple of any tile, Cout 728 and 2048 (last N tile partly
#: stored), Cin 728 (a K tail of 8) and Cin % 4 != 0 (4-byte copies), B 1.
F32_RAGGED = [(1, 19, 19, 728, 728), (1, 10, 10, 1536, 2048),
              (3, 7, 5, 22, 13), (2, 9, 11, 37, 100), (1, 37, 37, 256, 728),
              (1, 3, 3, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["sep2d", "pw1x1"])
def test_simt_f32_at_ragged_shapes(card, kernel, shape):
    """The float32 mainloop against its plain version where tiles,
    chunks and rows are ragged; NaN behind every operand and in the
    output's memory reaches no output."""
    b, h, w, cin, cout = shape
    if kernel == "sep2d":
        args = list(_sep2d_case(card, b, h, w, cin, cout, torch.float32,
                                seed=7))
        fn, plain = kernels.sep2d, kernels.plain_sep2d
        kw = {"relu_in": True}
    else:
        args = list(_pw1x1_case(card, b, h, w, cin, cout, torch.float32,
                                seed=7))
        fn, plain = kernels.pw1x1, kernels.plain_pw1x1
        kw = {"relu": True}
    ref = plain(*args, **kw)
    args = [_poisoned(a.contiguous()) for a in args]
    torch.cuda.synchronize()
    torch.full_like(ref, float("nan"))
    y, body = _launched_body(kernel, lambda: fn(*args, **kw))
    assert body == "simt_f32"
    assert bool(torch.isfinite(y).all())
    err = float((y - ref).abs().max())
    assert err <= _f32_bound(ref), err


@pytest.mark.cuda
def test_sep2d_unaligned_bf16_takes_the_simt_bf16_body(card):
    """bf16 rows that start 8 bytes off a 16-byte boundary: TMA cannot
    load them, so the first SIMT body runs them, under its own name."""
    x, dw9, pw, scale, shift = _sep2d_case(card, 2, 7, 9, 64, 48,
                                           torch.bfloat16, seed=8)
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=card)
    shifted = buf[4:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    y, body = _launched_body("sep2d", lambda: kernels.sep2d(
        shifted, dw9, pw, scale, shift))
    assert body == "simt_bf16"
    ref = kernels.plain_sep2d(shifted, dw9, pw, scale, shift)
    assert float((y.float() - ref.float()).abs().max()) \
        <= kernels.BF16_TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32,
                                      torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("src,dst", [((13, 17), (29, 23)),
                                     ((40, 36), (32, 32))])
def test_preproc_resize_matches_plain(card, in_dtype, out_dtype, src, dst):
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (2, *src, 3), generator=gen,
                      dtype=torch.uint8).to(card, in_dtype)
    y = kernels.preproc_resize(x, dst, out_dtype)
    torch.cuda.synchronize()
    ref = kernels.plain_preproc(x, dst, out_dtype)
    assert y.dtype == out_dtype and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    # bf16 output on the [0, 255] scale: one bf16 ulp is 1.0 there
    assert err <= (_f32_bound(ref.float()) if out_dtype == torch.float32
                   else 2.0), err


def _preproc_input(card, shape, dtype, seed=3):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8).to(card)
    return (torch.randn(shape, generator=gen) * 60.0).to(card, dtype)


#: (B, H, W, C, TH, TW): odd batches (unaligned image bases); an upscale
#: whose rows are 51 elements (no multiple of 16 bytes), a downscale at
#: C = 4, the identity at C = 1, one output row, a steep downscale, the
#: featurize path's 256×256 source, rows too wide to stage in float32,
#: and the 224×224 models' resize of a batch of 16 256×256 sources
PREPROC_EXACT = [(3, 13, 17, 3, 29, 23), (3, 40, 36, 4, 32, 32),
                 (5, 17, 13, 1, 17, 13), (3, 20, 30, 3, 1, 7),
                 (3, 600, 600, 3, 3, 3), (3, 256, 256, 3, 299, 299),
                 (1, 2, 15000, 4, 1, 5), (16, 256, 256, 3, 224, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32,
                                      torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PREPROC_EXACT, ids=str)
def test_preproc_resize_is_the_exact_order(card, shape, in_dtype, out_dtype):
    """Bit for bit the exact-order resize, and within the tolerance of
    ``plain_preproc``, for every dtype pair and plan mode."""
    b, h, w, c, th, tw = shape
    x = _preproc_input(card, (b, h, w, c), in_dtype)
    before = kernels.launches["preproc_resize"]
    y = kernels.preproc_resize(x, (th, tw), out_dtype)
    torch.cuda.synchronize()
    assert kernels.launches["preproc_resize"] == before + 1
    assert torch.equal(y, exact_order(x, th, tw, out_dtype))
    ref = kernels.plain_preproc(x, (th, tw), out_dtype)
    err = float((y.float() - ref.float()).abs().max())
    # bf16: the old bound of 2.0 on the [0, 255] scale, scaled with |ref|
    assert err <= (_f32_bound(ref.float()) if out_dtype == torch.float32
                   else 2.0 * max(1.0, float(ref.float().abs().max()) / 255)
                   ), err


@pytest.mark.cuda
@pytest.mark.parametrize("band_rows", [1, 2, 3, 5, 8, 16])
def test_preproc_resize_at_every_band_height(card, band_rows):
    """Plans pinned to other band heights (more runs, ragged last bands,
    other shared-memory layouts) give the same bits."""
    x = _preproc_input(card, (3, 256, 256, 3), torch.uint8, seed=4)
    out = torch.empty((3, 299, 299, 3), device=card)
    plan = kernels.plan_preproc(3, 256, 256, 3, 299, 299, torch.uint8,
                                torch.float32, band_rows=band_rows)
    kernels.launch_preproc(kernels._preproc_fn(), x, out, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, exact_order(x, 299, 299, torch.float32))


@pytest.mark.cuda
def test_wrappers_check_their_inputs(card):
    x = torch.zeros(1, 4, 4, 8, device=card)
    dw9, pw = torch.zeros(9, 8, device=card), torch.zeros(8, 4, device=card)
    sc, sh = torch.ones(4, device=card), torch.zeros(4, device=card)
    with pytest.raises(TypeError):
        kernels.sep2d(x, dw9.half(), pw, sc, sh)
    with pytest.raises(ValueError):
        kernels.sep2d(x.permute(0, 2, 1, 3), dw9, pw, sc, sh)
    with pytest.raises(ValueError):
        kernels.sep2d(x, dw9.cpu(), pw, sc, sh)
    with pytest.raises(TypeError):
        kernels.preproc_resize(x.half(), (2, 2), torch.float32)
    with pytest.raises(TypeError):
        kernels.pw1x1(x, pw.bfloat16(), sc, sh)
    with pytest.raises(ValueError):
        kernels.pw1x1(x, pw[:4], sc, sh)


@pytest.fixture
def force_routes(monkeypatch):
    """Every feasible kernel site routes, with no audition."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")


@pytest.mark.cuda
def test_xception_features_match_cpu(card, force_routes):
    """A whole Xception forward on the card (34 sep2d launches) against
    the same weights on the CPU, float32, 75×75: max|Δ| ≤ 1e-3·max|ref|."""
    from sparkdl_tpu_torch.models.registry import build_featurizer

    mf = build_featurizer("Xception", weights="random", seed=3)
    x = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), np.uint8)
    cpu = mf.apply_batch(x, batch_size=2, device="cpu")
    kernels.reset_launches()
    gpu = mf.apply_batch(x, batch_size=2, device=card)
    # the first sight of the shape: one eager warm-up, then one replay
    assert kernels.launches["sep2d"] == 2 * 34
    assert np.max(np.abs(gpu - cpu)) <= 1e-3 * np.abs(cpu).max()


@pytest.mark.cuda
def test_inception_module_path_matches_cpu(card, force_routes):
    """A whole InceptionV3 forward on the module path on the card (39
    pw1x1 launches) against the same weights on the CPU, float32, 75×75:
    max|Δ| ≤ 1e-3·max|ref|."""
    from sparkdl_tpu_torch.models.registry import build_featurizer

    mf = build_featurizer("InceptionV3", weights="random", seed=3,
                          fast=False)
    x = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), np.uint8)
    cpu = mf.apply_batch(x, batch_size=2, device="cpu")
    kernels.reset_launches()
    gpu = mf.apply_batch(x, batch_size=2, device=card)
    # the first sight of the shape: one eager warm-up, then one replay
    assert kernels.launches["pw1x1"] == 2 * 39
    assert np.max(np.abs(gpu - cpu)) <= 1e-3 * np.abs(cpu).max()


@pytest.mark.cuda
@pytest.mark.parametrize("name,src,per", [
    ("ResNet50", (224, 224), {}),
    ("ResNet50", (256, 256), {"preproc_resize": 1}),
    ("MobileNetV2", (224, 224), {}),
])
def test_zoo_features_match_cpu(card, force_routes, name, src, per):
    """A whole ResNet50 or MobileNetV2 featurizer on the card (plain
    cuDNN convs; ``preproc_resize`` once per forward where the source is
    not 224×224) against the same weights on the CPU, float32, two
    images: max|Δ| ≤ 1e-3·max|ref|."""
    from sparkdl_tpu_torch.models.registry import build_featurizer

    mf = build_featurizer(name, weights="random", seed=3).resized(src)
    x = np.random.default_rng(4).integers(0, 256, (2, *src, 3), np.uint8)
    cpu = mf.apply_batch(x, batch_size=2, device="cpu")
    kernels.reset_launches()
    gpu = mf.apply_batch(x, batch_size=2, device=card)
    # the first sight of the shape: one eager warm-up, then one replay
    assert {k: n for k, n in kernels.launches.items() if n} == \
        {k: 2 * n for k, n in per.items()}
    assert gpu.shape == cpu.shape == (2, 1280 if name == "MobileNetV2"
                                      else 2048)
    assert np.max(np.abs(gpu - cpu)) <= 1e-3 * np.abs(cpu).max()


def _graph_case(name):
    """(model, input) of one captured-graph case: Xception (34 ``sep2d``
    sites), InceptionV3's module path (39 ``pw1x1`` sites), or a
    weightless scale behind the ``preproc_resize`` prologue; with the
    launches of each kernel per forward."""
    from sparkdl_tpu_torch.core.model_function import (
        ModelFunction, TensorSpec,
    )
    from sparkdl_tpu_torch.models.registry import build_featurizer

    rng = np.random.default_rng(6)
    if name == "preproc_resize":
        mf = ModelFunction(lambda vs, x: x * 0.5, None,
                           TensorSpec((None, 29, 23, 3))).resized((40, 48))
        x = rng.integers(0, 256, (3, 40, 48, 3), np.uint8)
        return mf, x, {"preproc_resize": 1}
    if name == "sep2d":
        mf = build_featurizer("Xception", weights="random", seed=3)
        per = {"sep2d": 34}
    else:
        mf = build_featurizer("InceptionV3", weights="random", seed=3,
                              fast=False)
        per = {"pw1x1": 39}
    x = rng.integers(0, 256, (2, 75, 75, 3), np.uint8)
    return mf.flattened(), x, per


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sep2d", "pw1x1", "preproc_resize"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_graph_replay_equals_eager(card, force_routes, name, precision):
    """A fresh model captured at a new shape: each replay gives
    ``torch.equal`` results to the eager forward of the same chunk, and
    the launch counters advance by the kernels' launches per forward at
    each replay (the eager warm-up of the capture counts as one
    forward, the capture as none)."""
    mf, x, per = _graph_case(name)
    mf = mf.with_dtype(precision)
    mf.to(card)
    compiled = mf.jitted(card)
    chunk = torch.from_numpy(x).pin_memory()
    kernels.reset_launches()
    with torch.inference_mode():
        first = compiled(chunk, 2)
        torch.cuda.synchronize()
        assert {k: kernels.launches[k] for k in per} == \
            {k: 2 * n for k, n in per.items()}
        assert len(compiled.graphs) == 1
        kernels.reset_launches()
        again = [compiled(chunk, 2) for _ in range(3)]
        torch.cuda.synchronize()
        assert {k: kernels.launches[k] for k in per} == \
            {k: 3 * n for k, n in per.items()}
        kernels.reset_launches()
        eager = mf(chunk.to(card).to(torch.float32))[:2]
        torch.cuda.synchronize()
    assert {k: kernels.launches[k] for k in per} == per
    assert first.shape == eager.shape
    for out in [first] + again:
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("src", [(75, 75), (64, 64)])
def test_int8_replay_reads_each_forwards_weights(card, force_routes, src):
    """Under int8 each route sees the weight its forward dequantized: a
    replay after the int8 weights change in place equals the eager
    forward of the new weights (the graph reads the int8 buffers, and no
    weight layout made at capture), the float32 body's layout cache
    (``kernels._kn_weights``) gains no entry, and the graph holds no
    reference to a weight outside its pool. At 75×75 the network runs in
    bf16 (tensor-core body); behind the 64→75 resize in float32 with the
    dequantized bf16 weights (``simt_f32``)."""
    mf, _, per = _graph_case("sep2d")
    if src != (75, 75):
        mf = mf.resized(src, (75, 75))
    run = mf.with_dtype("int8")
    run.to(card)
    compiled = run.jitted(card)
    x = np.random.default_rng(9).integers(0, 256, (2, *src, 3), np.uint8)
    chunk = torch.from_numpy(x).pin_memory()
    layouts = len(kernels._kn_weights)
    body = "wgmma" if src == (75, 75) else "simt_f32"
    before = kernels.launches_by_body["sep2d"][body]
    with torch.inference_mode():
        first = compiled(chunk, 2)
        torch.cuda.synchronize()
    assert kernels.launches_by_body["sep2d"][body] == before + 2 * per[
        "sep2d"]
    unit = run.variables.get_submodule("block5_sepconv1").pointwise
    unit.weight_q8.neg_()  # in place: the graph reads the same address
    with torch.inference_mode():
        again = compiled(chunk, 2)
        eager = run(chunk.to(card).to(torch.float32))[:2]
        torch.cuda.synchronize()
    assert not torch.equal(first, again)
    assert torch.equal(again, eager)
    assert len(kernels._kn_weights) == layouts
    (graph,) = compiled.graphs.values()
    # what it holds are the resize's tables, none a (dequantized) weight
    assert not [t for t in graph.held if t.dtype == torch.bfloat16]


@pytest.mark.cuda
def test_graph_of_each_rung_and_mode(card, force_routes, monkeypatch):
    """One graph per rung (20 rows at batch 16: rungs 16 and 8); a graph
    captured under "force" never replays under "off", and
    kernels.reset() (a new verdict generation) captures again, each new
    capture dropping the stale graph of its shape."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    mf, x, _ = _graph_case("preproc_resize")
    mf.to(card)
    compiled = mf.jitted(card)
    x20 = np.concatenate([x] * 7)[:20]
    out = mf.apply_batch(x20, batch_size=16, device=card, prefetch=2)
    assert sorted(k[0][0] for k in compiled.graphs) == [8, 16]
    np.testing.assert_array_equal(
        mf.apply_batch(x20[:3], batch_size=16, device=card), out[:3])
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "off")
    kernels.reset_launches()
    off = mf.apply_batch(x20, batch_size=16, device=card)
    assert kernels.launches["preproc_resize"] == 0
    assert sorted(k[2] for k in compiled.graphs) == ["off", "off"]
    np.testing.assert_allclose(off, out, rtol=0, atol=1e-3)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    generation = kernels.generation()
    kernels.reset()
    assert kernels.generation() == generation + 1
    again = mf.apply_batch(x20, batch_size=16, device=card)
    assert sorted(k[2:] for k in compiled.graphs) == \
        [("force", generation + 1)] * 2
    np.testing.assert_array_equal(again, out)


_SYNC_IN_FORWARD = """
import torch
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec

def body(vs, x):
    if float(x.sum().item()) > -1:   # a host sync inside the forward
        return x * 2.0
    return x

mf = ModelFunction(body, None, TensorSpec((None, 4, 4, 3)))
chunk = torch.zeros(2, 4, 4, 3).pin_memory()
try:
    with torch.inference_mode():
        mf.jitted("cuda")(chunk, 2)
except Exception as e:  # the capture must fail, not run eagerly
    print("raised", type(e).__name__, str(e).splitlines()[0][:200])
else:
    print("no error")
"""


@pytest.mark.cuda
def test_sync_in_forward_raises_at_capture(card, tmp_path):
    """``.item()`` inside a forward cannot be captured: the call raises
    (no eager run in its place). A failed capture can leave the CUDA
    context unusable, so it runs in a process of its own."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "sync_in_forward.py"
    script.write_text(_SYNC_IN_FORWARD)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("raised"), \
        out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fma9", "dw2d", "sep2d_probe"])
@pytest.mark.parametrize("b", [1, 2, 3, 128])
def test_probe_kernel_matches_plain_on_all_rows(card, name, b):
    """Each probe kernel against its plain version on every row, the dead
    pad rows included: ``fma9`` and ``dw2d`` bit for bit, ``sep2d_probe``
    within one bf16 ulp of |ref| + 1e-3 (``probe.matches_plain``). b = 1
    and 3 leave the last 128-row tile of ``dw2d`` and the last cluster of
    64-row tiles of ``sep2d_probe`` ragged."""
    from sparkdl_tpu_torch.experiments import probe

    v = probe.operands(card, b=b, seed=1)
    args = [v["k9"]]
    if name == "sep2d_probe":
        args += [v["pw"], v["sc"], v["sh"]]
    before = probe.launches[name]
    y = getattr(probe, name)(v["x2"], *args)
    torch.cuda.synchronize()
    assert probe.launches[name] == before + 1
    ref = getattr(probe, f"plain_{name}")(v["x2"], *args)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    assert probe.matches_plain(name, y, ref), err
    if name == "dw2d":  # the dead rows read the image's last live row
        dead = ref.float().reshape(b, probe.P_PAD, probe.C)[:, probe.P:]
        assert float(dead.abs().max()) > 0.0


def _poisoned(t: torch.Tensor, extra: int = 4096) -> torch.Tensor:
    """A copy of ``t`` at the front of a buffer whose remaining ``extra``
    elements are NaN: a kernel that reads past the tensor's end picks up
    NaN."""
    buf = torch.full((t.numel() + extra,), float("nan"), dtype=t.dtype,
                     device=t.device)
    view = buf[:t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_sep2d_probe_zeroes_the_k_tail(card, b):
    """728 = 11 x 64 + 24 input channels: the last K chunk is zero past
    channel 728 on both operands (the producers write zeros into A, TMA
    zero-fills pw's rows), so NaN behind every input and in the memory
    the output takes reaches no output; every output is written."""
    from sparkdl_tpu_torch.experiments import probe

    v = probe.operands(card, b=b, seed=2)
    args = [_poisoned(v[k]) for k in ("x2", "k9", "pw", "sc", "sh")]
    ref = probe.plain_sep2d_probe(*args)
    # the output's block comes from the allocator's cache: fill it with
    # NaN first
    torch.cuda.synchronize()
    torch.full_like(ref, float("nan"))
    y = probe.sep2d_probe(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    assert probe.matches_plain("sep2d_probe", y, ref), \
        float((y.float() - ref.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fma9", "dw2d", "sep2d_probe"])
def test_probe_wrapper_launches_one_kernel(card, name):
    """One wrapper call runs exactly one kernel on the card (its own: no
    copy of pw, no fill of the output), as the device's profiler counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.experiments import probe

    v = probe.operands(card, b=2, seed=3)
    args = [v["x2"], v["k9"]]
    if name == "sep2d_probe":
        args += [v["pw"], v["sc"], v["sh"]]
    fn = getattr(probe, name)
    fn(*args)  # builds and warms up outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ran) == 1 and f"{name}_kernel" in ran[0], ran


@pytest.mark.cuda
@pytest.mark.parametrize("site", [
    kernels.Site("sep2d", "unit", (2, 19, 19, 728, 728), "bfloat16"),
    kernels.Site("pw1x1_relu", "unit", (2, 8, 8, 256, 64), "bfloat16"),
    kernels.Site("preproc", "unit", (2, 40, 48, 3, 75, 75),
                 "float32->float32"),
], ids=lambda s: s.kernel)
def test_audition_on_the_card_times_both(card, site, monkeypatch):
    monkeypatch.delenv(kernels.COMPILE_CACHE_DIR_ENV, raising=False)
    kernels.reset()
    verdict = kernels.ensure_verdict(site, card)
    assert verdict["kernel_s"] > 0 and verdict["twin_s"] > 0
    assert verdict["backend"].endswith("sm_90"), verdict
    assert isinstance(verdict["adopted"], bool) and verdict["reason"]
    assert kernels.verdict_for(site, card) is verdict
    kernels.reset()


@pytest.mark.cuda
def test_failing_kernel_raises_out_of_ensure_verdict(card, monkeypatch):
    """A launch the library refuses (an unknown dtype code) raises out of
    the audition: no failure on the card becomes a rejection."""
    monkeypatch.delenv(kernels.COMPILE_CACHE_DIR_ENV, raising=False)
    monkeypatch.setitem(kernels._DTYPE_CODES, torch.bfloat16, 7)
    kernels.reset()
    site = kernels.Site("pw1x1", "unit", (2, 8, 8, 64, 64), "bfloat16")
    with pytest.raises(RuntimeError, match="pw1x1 kernel launch failed"):
        kernels.ensure_verdict(site, card)
    assert kernels.verdict_for(site, card) is None


@pytest.mark.cuda
def test_threads_replay_two_programs_with_exact_launches(card,
                                                         force_routes):
    """8 threads × 2 programs (Xception in bf16: 34 ``sep2d`` a forward;
    a scale behind ``preproc_resize``: 1), all starting together: each
    program is captured once, its graph records exactly one forward's
    launches whatever the other threads replayed meanwhile, and the
    counters end at (1 warm-up + every call) × launches per forward.
    Every output equals the single-threaded one."""
    import threading

    cases = []
    for name in ("sep2d", "preproc_resize"):
        mf, x, per = _graph_case(name)
        mf = mf.with_dtype("bfloat16")
        mf.to(card)
        cases.append((mf.jitted(card), torch.from_numpy(x).pin_memory(),
                      per))
    calls = 4
    outs = [[] for _ in range(8)]
    errors = []
    barrier = threading.Barrier(8, timeout=120)

    def work(i):
        compiled, chunk, _ = cases[i % 2]
        try:
            with torch.cuda.device(card), torch.inference_mode():
                barrier.wait()
                for _ in range(calls):
                    outs[i].append(compiled(chunk, 2))
                torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    kernels.reset_launches()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert not errors, errors
    expected = {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}
    for compiled, _, per in cases:
        (graph,) = compiled.graphs.values()
        assert {k: n for k, n in graph.launches["launches"].items() if n} \
            == per
        assert graph.pool_bytes > 0
        for k, n in per.items():
            expected[k] += n * (1 + 4 * calls)
    assert kernels.launches == expected
    for i in range(2, 8):
        for a, b in zip(outs[i], outs[i % 2]):
            assert torch.equal(a, b)



_OOM_IN_CAPTURE = r'''
import torch
from sparkdl_tpu_torch.core import resilience
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec

def fn(vs, x):
    if torch.cuda.is_current_stream_capturing():
        torch.empty(1 << 45, dtype=torch.uint8, device=x.device)
    return x * 2

mf = ModelFunction(fn, None, TensorSpec((None, 4)))
compiled = mf.jitted("cuda")
chunk = torch.ones(8, 4)
try:
    with torch.inference_mode():
        compiled(chunk, 8)
except Exception as e:
    assert resilience.classify(e) == resilience.OOM, repr(e)
    assert not compiled.graphs
    ok = ModelFunction(lambda vs, x: x * 3, None, TensorSpec((None, 4)))
    with torch.inference_mode():
        y = ok.jitted("cuda")(chunk, 8)
    assert torch.equal(y.cpu(), chunk * 3)
    print("raised", type(e).__name__)
else:
    print("no error")
'''


@pytest.mark.cuda
def test_oom_inside_capture_stores_no_graph(card, tmp_path):
    """An allocation that fails inside the capture (and not in the eager
    warm-up) raises an error ``classify`` calls OOM, stores no graph,
    and leaves the context able to capture and replay another program.
    It runs in a process of its own, as a failed capture may leave the
    context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "oom_in_capture.py"
    script.write_text(_OOM_IN_CAPTURE)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("raised"), \
        out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("standardization", [True, False])
def test_logistic_regression_fits_on_the_card_as_on_the_cpu(
        card, standardization):
    """``LogisticRegression`` fits on the card by default
    (``EngineConfig.device = "cuda"``) and agrees with the port's CPU fit
    of the same frame: coefficients within ``1e-3·max|cpu|``, the same
    predictions, the objective within ``1e-5`` relative."""
    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.ml.classification import SoftmaxObjective

    rng = np.random.default_rng(7)
    n, d, k = 512, 64, 4
    y = rng.integers(0, k, n)
    x = (rng.normal(size=(k, d))[y] + 2.0 * rng.normal(size=(n, d))
         ).astype(np.float32)
    df = s.DataFrame.fromColumns({"features": x, "label": y.tolist()},
                                 numPartitions=4)
    saved = s.EngineConfig.snapshot()
    try:
        s.EngineConfig.device = "cuda"
        lr = s.LogisticRegression(maxIter=100, regParam=0.01,
                                  standardization=standardization)
        gpu = lr.fit(df)
        s.EngineConfig.device = "cpu"
        cpu = lr.fit(df)
    finally:
        s.EngineConfig.restore(saved)
    assert gpu.fitStats["device"].startswith("cuda")
    assert cpu.fitStats["device"] == "cpu"
    limit = 1e-3 * float(np.abs(cpu.coefficients).max())
    assert float(np.abs(gpu.coefficients - cpu.coefficients).max()) <= limit

    def objective(model):
        f = SoftmaxObjective(torch.from_numpy(x), torch.from_numpy(y), k,
                             0.01, True)
        w = torch.from_numpy(model.coefficients)
        if standardization:
            w = w * torch.from_numpy(x.std(axis=0, ddof=1))[:, None]
            f.x = f.x / torch.from_numpy(x.std(axis=0, ddof=1))
        p = torch.cat([w.reshape(-1), torch.from_numpy(model.intercept)])
        return float(f(p)[0])

    assert abs(objective(gpu) - objective(cpu)) <= 1e-5 * objective(cpu)
    preds = [[r["prediction"] for r in m.transform(df).collect()]
             for m in (gpu, cpu)]
    assert preds[0] == preds[1]


@pytest.fixture
def serving_config(card):
    """The engine's knobs back as they were, the executor fresh."""
    from sparkdl_tpu_torch.core import executor
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    saved = EngineConfig.snapshot()
    EngineConfig.device = "cuda"
    executor.reset()
    yield EngineConfig
    executor.reset()
    EngineConfig.restore(saved)


def _served_resnet(seed):
    from sparkdl_tpu_torch.models import registry

    return registry.build_featurizer("ResNet50", seed=seed,
                                     precision="bfloat16")


@pytest.mark.cuda
def test_eviction_frees_at_least_the_weight_bytes(serving_config):
    """A served model evicted from the residency manager gives back at
    least its ``weight_bytes()`` of ``torch.cuda.memory_allocated()``,
    and every segment of its graph memory pools: nothing (the executor's
    state, the captured graphs, the variants, a library workspace first
    used in a capture) keeps its weights, its graphs' outputs or their
    pools alive. ResNet50's featurizer and VGG16's, whose fully connected
    layers run cuBLAS GEMMs."""
    import gc

    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.core import model_function
    from sparkdl_tpu_torch.models import registry

    dev = torch.device("cuda", torch.cuda.current_device())
    row = np.random.default_rng(0).integers(0, 256, (224, 224, 3),
                                            dtype=np.uint8)
    res = serving.ResidencyManager(1 << 34)
    reg = serving.ModelRegistry(residency=res)
    srv = serving.ModelServer(reg)
    for name, loader in (
            ("r50", lambda: _served_resnet(0)),
            ("vgg", lambda: registry.build_featurizer(
                "VGG16", seed=0, precision="bfloat16"))):
        reg.deploy(name, "v1", loader=loader, batch_size=4)
        res.pin(name, "v1", pinned=False)
        for _ in range(2):
            assert srv.predict(name, row).output.ndim == 1
        weight_bytes = res.resident_bytes_for(name, "v1")
        assert weight_bytes > 40 << 20
        pools = [p._pool for m in res.acquire(name, "v1").device_variants()
                 for p in m._programs.values()
                 if p.device == dev and p._pool is not None]

        def pool_bytes():
            return sum(model_function._pool_bytes(dev, pool)
                       for pool in pools)

        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        reserved, held = torch.cuda.memory_reserved(), pool_bytes()
        assert held > 0
        assert res.evict(name, "v1")
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        assert freed >= weight_bytes, (name, freed, weight_bytes)
        torch.cuda.empty_cache()
        assert pool_bytes() == 0, name
        assert reserved - torch.cuda.memory_reserved() >= held, \
            (name, reserved, held)


@pytest.mark.cuda
def test_warmed_deployment_first_request_captures_no_graph(serving_config):
    """Under ``serving_warmup`` the deployment captures every rung of its
    ladder (uint8 rows included) before traffic, so its first requests,
    alone and coalesced, capture nothing."""
    import threading

    from sparkdl_tpu_torch import serving

    serving_config.serving_warmup = True
    reg = serving.ModelRegistry()
    reg.deploy("r50", "v1", loader=lambda: _served_resnet(1), batch_size=8)
    model = reg.deployment("r50").model()
    dev = torch.device("cuda", torch.cuda.current_device())
    graphs = dict(model.jitted(dev).graphs)
    assert sorted(k[0][0] for k in graphs) == [8, 8]  # float32 and uint8
    srv = serving.ModelServer(reg)
    rows = np.random.default_rng(1).integers(0, 256, (4, 224, 224, 3),
                                             dtype=np.uint8)
    out = [None] * 4
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, srv.predict("r50", rows[i]).output)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None and o.shape == (2048,) for o in out)
    assert model.jitted(dev).graphs.keys() == graphs.keys()


@pytest.mark.cuda
def test_cluster_serves_testnet_on_two_workers(serving_config):
    """``serving_cluster`` on 2 workers sharing the card: TestNet (float32,
    seeded weights built in each worker) answers single rows and a batch
    routed to its replicas within the float32 bound of the eager forward
    of the same weights here; a cutover to another seed's weights and a
    rollback are cluster-atomic. The workers compute with this process's
    TF32 settings (off, by the ``card`` fixture). The loaders are partials
    of the registry's builder, which a worker imports by name (a loader
    of this test module would need ``tests`` importable there)."""
    import functools

    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.models import registry
    from sparkdl_tpu_torch.serving import cluster as serving_cluster
    from sparkdl_tpu_torch.serving.residency import place

    serving_config.inference_precision = "float32"
    serving_config.cluster_workers = 2
    serving_config.serving_cluster = True
    rows = np.random.default_rng(2).integers(0, 256, (5, 32, 32, 3),
                                             dtype=np.uint8)
    try:
        reg = serving.ModelRegistry()
        srv = serving.ModelServer(reg)
        for version, seed in (("v1", 3), ("v2", 4)):
            reg.deploy("tn", version, batch_size=4,
                       loader=functools.partial(registry.build_featurizer,
                                                "TestNet", seed=seed))

        def eager(seed):
            model = place(registry.build_featurizer("TestNet", seed=seed))
            with torch.inference_mode():
                x = torch.from_numpy(rows).to("cuda").float()
                return model(x).float().cpu().numpy()

        def held(seed, version):
            ref = eager(seed)
            got = [srv.predict("tn", r, deadline_ms=120_000)
                   for r in rows]
            got.append(srv.predict("tn", rows[:3], deadline_ms=120_000))
            assert {g.version for g in got} == {version}
            out = np.concatenate([np.stack([g.output for g in got[:-1]]),
                                  got[-1].output])
            want = np.concatenate([ref, ref[:3]])
            assert out.shape == want.shape and np.isfinite(out).all()
            err = float(np.abs(out - want).max())
            assert err <= _f32_bound(torch.from_numpy(want)), err

        held(3, "v1")
        assert srv.cutover("tn", "v2") == "v1"
        held(4, "v2")
        assert srv.rollback("tn") == "v2"
        held(3, "v1")
        status = srv.status()["cluster"]["tn"]
        assert status["active"] == "v1" and len(status["replicas"]) == 2
        router = cluster_router.maybe_router()
        router.close()
        section = router.cluster_report["serving"]["router"]
        assert section["cutovers"] == 2 and section["failovers"] == 0
        assert router.cluster_report["device"]["forwards"] > 0
    finally:
        cluster_router.shutdown()
        serving_cluster.reset()



# -- training (train/) -------------------------------------------------------

def _train_stack(seed=0):
    """A small ConvBN → SeparableConvBN → Dense stack with seeded
    weights: train-mode BatchNorm on the card."""
    from sparkdl_tpu_torch.models import layers

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unit1 = layers.ConvBN(3, 16, 3, strides=2)
            self.unit2 = layers.SeparableConvBN(16, 32,
                                                kernel_family="stack")
            self.head = layers.Dense(32, 4)

        def forward(self, x):
            x = self.unit2(self.unit1(x / 127.5 - 1.0)).mean(dim=(1, 2))
            return torch.softmax(self.head(x), dim=-1)

    net = Stack()
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, (layers.Conv2d, layers.Dense)):
            layers.lecun_normal_(m.weight, gen)
    return net


def _train_batches(n=4, batch=8, size=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 4, batch)
        x = rng.integers(0, 128, (batch, size, size, 3)) + ids[:, None,
                                                               None, None] * 30
        out.append((x.astype(np.uint8), np.eye(4, dtype=np.float32)[ids]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_fit_on_the_card_matches_the_cpu(card, optimizer):
    """Two epochs of the pipelined fit (uint8 staged pinned, cast on the
    card) on the card and on the CPU from one state: losses rtol 1e-4,
    params and running statistics within 1e-4·max(1, max|cpu|) (another
    summation order; Adam's first steps scale each gradient's sign)."""
    from sparkdl_tpu_torch.train import MetricsLogger, Trainer

    batches = _train_batches()
    runs = {}
    for device in ("cpu", "cuda"):
        trainer, state = Trainer.from_module(
            _train_stack(), optimizer=optimizer, learning_rate=1e-3,
            device=device)
        log = MetricsLogger(sinks=[lambda r: None])
        state = trainer.fit(state, batches, epochs=2, metrics_logger=log,
                            sync_every=3)
        assert state.step.device.type == device
        runs[device] = (state, [r["loss"] for r in log.history], trainer)
    (cpu, cpu_loss, _), (gpu, gpu_loss, trainer) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-4)
    assert trainer.fit_stats["syncs"] == 4  # steps 3, 6 and two epoch ends
    for tree in ("params", "model_state"):
        for name, ref in getattr(cpu, tree).items():
            got = getattr(gpu, tree)[name].detach().cpu()
            bound = 1e-4 * max(1.0, float(ref.detach().abs().max()))
            assert float((got - ref.detach()).abs().max()) <= bound, name


@pytest.mark.cuda
def test_train_bf16_keeps_float32_masters_and_statistics(card):
    from sparkdl_tpu_torch.train import Trainer

    trainer, state = Trainer.from_module(_train_stack(), optimizer="adam",
                                         compute_dtype=torch.bfloat16,
                                         device="cuda")
    stats0 = {k: v.clone() for k, v in state.model_state.items()}
    state = trainer.fit(state, _train_batches(), epochs=1)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(t.dtype == torch.float32
               for slot in ("mu", "nu")
               for t in state.opt_state[slot].values())
    assert all(b.dtype == torch.float32 for b in state.model_state.values())
    assert any(not torch.equal(stats0[k], v)
               for k, v in state.model_state.items())


@pytest.mark.cuda
def test_train_checkpoint_round_trips_a_card_state(card, tmp_path):
    """Params, moments, running statistics and the card's generator come
    back bit for bit, on the card."""
    from sparkdl_tpu_torch.train import CheckpointManager, Trainer

    trainer, state = Trainer.from_module(_train_stack(), optimizer="adam",
                                         device="cuda")
    state = trainer.fit(state, _train_batches(), epochs=1)
    torch.rand(3, generator=state.rng, device="cuda")
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(int(state.step), state)
    ckpt.wait_until_finished()
    _, template = Trainer.from_module(_train_stack(), optimizer="adam",
                                      device="cuda")
    got = ckpt.restore(template)
    ckpt.close()
    assert got.step.device.type == "cuda" and int(got.step) == 4
    for tree in ("params", "model_state"):
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(got, tree)[k], v), k
    for k, v in state.opt_state["mu"].items():
        assert torch.equal(got.opt_state["mu"][k], v)
    assert torch.equal(got.rng.get_state(), state.rng.get_state())


@pytest.mark.cuda
def test_train_grad_through_a_routed_kernel_raises(card, monkeypatch):
    """Under "force" a fused unit in eval mode routes sep2d; with grad
    recording it raises instead of returning an output with no graph,
    and under no_grad it launches the kernel."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig
    from sparkdl_tpu_torch.models.layers import SeparableConvBN

    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    unit = SeparableConvBN(32, 64, kernel_family="unit").to(card).eval()
    x = torch.randn(2, 9, 9, 32, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        unit(x)
    before = kernels.launches["sep2d"]
    with torch.no_grad():
        unit(x)
    torch.cuda.synchronize()
    assert kernels.launches["sep2d"] == before + 1
