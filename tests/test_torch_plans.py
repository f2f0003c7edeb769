"""The launch plans of the port's ``sep2d`` and ``pw1x1`` kernels, on the CPU.

``plan_sep2d`` and ``plan_pw1x1`` (``sparkdl_tpu_torch/core/kernels.py``)
are pure functions of a call's shape and dtype: the body that runs (the
Hopper tensor-core mainloop ``"wgmma"``, ``"mma"``, the float32 SIMT
mainloop ``"simt_f32"`` or ``"simt_bf16"``), its tile, its ring and its
split of K. The C launchers check a plan and refuse one they cannot run,
so these tests hold the plans at every main-path site: K covered exactly
once, a wave of blocks or a stated reason, every bf16 site on the tensor
cores, TMA row strides of 16 bytes, shared memory within the block's
limit, the float32 body's rounds, fill and depthwise recompute, the same
plan every time.
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import kernels

BATCH = 16  # the featurize path's batch
#: Xception's sep2d sites at 299×299: (H = W, Cin, Cout)
XCEPTION_SEP2D = [(147, 64, 128), (147, 128, 128), (74, 128, 256),
                  (74, 256, 256), (37, 256, 728), (37, 728, 728),
                  (19, 728, 728), (19, 728, 1024), (10, 1024, 1536),
                  (10, 1536, 2048)]
#: InceptionV3's 1×1 pw1x1 sites at 299×299: (H = W, Cin, Cout)
INCEPTION_PW1X1 = [(35, 192, 32), (35, 192, 48), (35, 192, 64),
                   (35, 256, 48), (35, 256, 64), (35, 288, 48),
                   (35, 288, 64), (17, 768, 128), (17, 768, 160),
                   (17, 768, 192), (8, 1280, 192), (8, 1280, 320),
                   (8, 1280, 384), (8, 1280, 448), (8, 2048, 192),
                   (8, 2048, 320), (8, 2048, 384), (8, 2048, 448)]
DTYPES = [torch.float32, torch.bfloat16]


def _sep2d(site, dtype):
    hw, cin, cout = site
    return kernels.plan_sep2d(BATCH, hw, hw, cin, cout, dtype)


def _pw1x1(site, dtype):
    hw, cin, cout = site
    return kernels.plan_pw1x1(BATCH * hw * hw, cin, cout, dtype)


def _site_id(site):
    return "%dx%d_%d_%d" % (site[0], site[0], site[1], site[2])


def _all_plans():
    for dtype in DTYPES:
        for site in XCEPTION_SEP2D:
            yield "sep2d", site, dtype, _sep2d(site, dtype)
        for site in INCEPTION_PW1X1:
            yield "pw1x1", site, dtype, _pw1x1(site, dtype)


PLANS = list(_all_plans())
PLAN_IDS = ["%s-%s-%s" % (k, _site_id(s), str(d)[6:]) for k, s, d, _ in PLANS]


@pytest.mark.parametrize("kernel,site,dtype,plan", PLANS, ids=PLAN_IDS)
def test_split_k_covers_k_exactly_once(kernel, site, dtype, plan):
    """The shares of K are contiguous, non-empty, in order and cover the
    chunks of Cin once; the chunks cover Cin with less than a chunk over."""
    cin = site[1]
    assert plan.chunks * plan.chunk >= cin > (plan.chunks - 1) * plan.chunk
    ranges = plan.k_ranges
    assert len(ranges) == plan.splits == plan.grid[2]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(e > b for b, e in ranges)
    covered = np.zeros(plan.chunks, int)
    for b, e in ranges:
        covered[b:e] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("kernel,site,dtype,plan", PLANS, ids=PLAN_IDS)
def test_grid_fills_a_wave_or_says_why(kernel, site, dtype, plan):
    if plan.blocks >= kernels.SMS:
        return
    assert plan.note, f"{plan} is under one wave and does not say why"


@pytest.mark.parametrize("kernel,site,plan", [
    (k, s, p) for k, s, d, p in PLANS if d == torch.bfloat16],
    ids=[i for i, (_, _, d, _) in zip(PLAN_IDS, PLANS)
         if d == torch.bfloat16])
def test_bf16_sites_take_the_tensor_core_body(kernel, site, plan):
    assert site[1] % 8 == 0
    assert plan.body == "wgmma"
    # TMA row strides of a multiple of 16 bytes: x (Cin) and w (Cin)
    assert site[1] * 2 % 16 == 0
    assert plan.smem <= kernels.SMEM_LIMIT
    assert 2 <= plan.stages <= 4


@pytest.mark.parametrize("kernel,site,dtype,plan", PLANS, ids=PLAN_IDS)
def test_float32_sites_take_the_simt_body(kernel, site, dtype, plan):
    """Every float32 site runs the shared SIMT mainloop, its persistent
    blocks one on each SM, its shared memory as the launcher counts it."""
    if dtype != torch.float32:
        return
    assert plan.body == "simt_f32" and plan.smem <= kernels.SMEM_LIMIT
    hw, cin, cout = site
    sep = kernel == "sep2d"
    assert plan.smem == kernels._f32_smem(
        sep, plan.layout == "resident", plan.bm, plan.bn, hw if sep else 0,
        plan.stages, plan.chunks, plan.splits)
    assert plan.grid[0] == min(plan.units, kernels.SMS) // plan.splits
    assert plan.producers >= 64 and plan.producers % 64 == 0
    assert plan.bm // 8 * plan.bn // 8 + plan.producers <= 384


@pytest.mark.parametrize("site", XCEPTION_SEP2D, ids=_site_id)
def test_sep2d_depthwise_runs_at_most_ceil_cout_over_256_times(site):
    """One output tile up to 256 channels wide: a position tile's
    depthwise is computed once per channel tile."""
    plan = _sep2d(site, torch.bfloat16)
    cout = site[2]
    assert plan.grid[1] == -(-cout // plan.bn) <= -(-cout // 256)
    boxes, box_rows, nbytes = kernels.sep2d_halo(site[0])
    assert box_rows <= 256 and boxes * box_rows >= 64 + 2 * site[0] + 2
    assert nbytes == boxes * box_rows * 128
    assert 2 <= plan.halo_slots <= 4


@pytest.mark.parametrize("cout,bn", [(32, 32), (48, 48), (64, 64),
                                     (160, 32), (192, 64), (384, 128),
                                     (448, 64)])
def test_pw1x1_tile_width_pads_cout_least(cout, bn):
    plan = kernels.plan_pw1x1(BATCH * 35 * 35, 192, cout, torch.bfloat16)
    assert plan.bn == bn


def test_pw1x1_8x8_splits_k_to_fill_the_card():
    """8×8 2048→448 at batch 16: 112 bf16 tiles and 56 float32 tiles, K in
    two shares each (the float32 shares meet in a cluster of two, and the
    plan says why that beats finer tiles)."""
    bf16 = kernels.plan_pw1x1(BATCH * 64, 2048, 448, torch.bfloat16)
    f32 = kernels.plan_pw1x1(BATCH * 64, 2048, 448, torch.float32)
    assert (bf16.grid[0] * bf16.grid[1], f32.grid[0] * f32.grid[1]) == (112,
                                                                        56)
    assert bf16.splits == 2 and f32.splits == 2
    assert bf16.blocks >= kernels.SMS
    assert f32.blocks == f32.units == 112 <= kernels.SMS
    assert "unsplit tiling" in f32.note


@pytest.mark.parametrize("cin,cout,dtype,body", [
    (20, 36, torch.bfloat16, "mma"), (37, 13, torch.bfloat16, "mma"),
    (20, 36, torch.float32, "simt_f32"), (37, 13, torch.float32, "simt_f32"),
    (16, 13, torch.bfloat16, "wgmma"), (40, 100, torch.bfloat16, "wgmma")])
def test_pw1x1_ragged_widths_get_a_body_that_can_load_them(cin, cout, dtype,
                                                          body):
    """TMA needs row strides of a multiple of 16 bytes (Cin % 8 == 0 in
    bf16); a ragged Cin takes the mma.sync body, a ragged Cout is
    zero-filled by TMA."""
    plan = kernels.plan_pw1x1(3 * 3 * 5, cin, cout, dtype)
    assert plan.body == body
    if plan.body == "wgmma":
        assert cin * 2 % 16 == 0
    assert plan.splits == 1


@pytest.mark.parametrize("cin,cout,dtype,body", [
    (20, 24, torch.bfloat16, "simt_bf16"), (16, 72, torch.bfloat16, "wgmma"),
    (40, 24, torch.bfloat16, "wgmma"), (728, 100, torch.bfloat16, "wgmma"),
    (20, 24, torch.float32, "simt_f32")])
def test_sep2d_ragged_widths_get_a_body_that_can_load_them(cin, cout, dtype,
                                                          body):
    plan = kernels.plan_sep2d(2, 7, 9, cin, cout, dtype)
    assert plan.body == body
    if plan.body == "wgmma":
        assert cin * 2 % 16 == 0 and plan.bn >= min(cout, 256) - 63


def test_unaligned_operands_leave_the_tensor_cores():
    assert kernels.plan_pw1x1(64, 64, 64, torch.bfloat16,
                              aligned=False).body == "mma"
    assert kernels.plan_sep2d(1, 8, 8, 64, 64, torch.bfloat16,
                              aligned=False).body == "simt_bf16"


@pytest.mark.parametrize("kernel", ["sep2d", "pw1x1"])
def test_plans_are_deterministic(kernel):
    fn = kernels.plan_sep2d if kernel == "sep2d" else kernels.plan_pw1x1
    sites = XCEPTION_SEP2D if kernel == "sep2d" else INCEPTION_PW1X1
    plan = _sep2d if kernel == "sep2d" else _pw1x1
    first = [plan(s, d) for d in DTYPES for s in sites]
    fn.cache_clear()
    again = [plan(s, d) for d in DTYPES for s in sites]
    assert first == again
    # the dtype by name plans as the dtype itself
    assert plan(sites[0], "bfloat16") == plan(sites[0], torch.bfloat16)


def test_routes_pass_the_weight_without_a_copy():
    """The kernels read (Cout, Cin); a (Cin, Cout) weight that is the
    transpose of a contiguous (Cout, Cin) tensor is read as it lies."""
    w = torch.randn(24, 40)
    assert kernels._weight_nk(w.t()).data_ptr() == w.data_ptr()
    copied = kernels._weight_nk(w.t().contiguous())
    assert copied.is_contiguous() and torch.equal(copied, w)


def test_cpu_wrappers_take_either_weight_layout():
    """On the CPU the wrappers run their plain versions, whatever the
    weight's memory layout."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 6, 16, generator=gen)
    dw9 = torch.randn(9, 16, generator=gen)
    w = torch.randn(24, 16, generator=gen)
    sc, sh = torch.rand(24, generator=gen), torch.randn(24, generator=gen)
    assert torch.equal(kernels.sep2d(x, dw9, w.t(), sc, sh),
                       kernels.sep2d(x, dw9, w.t().contiguous(), sc, sh))
    assert torch.equal(kernels.pw1x1(x, w.t(), sc, sh, relu=True),
                       kernels.pw1x1(x, w.t().contiguous(), sc, sh,
                                     relu=True))
    assert kernels.launches == {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}


#: chip_smoke's float32 kernel checks: sep2d (H = W, Cin, Cout) and pw1x1
#: (H = W, Cin, Cout), batch 16
SMOKE_SEP2D = [(147, 64, 128), (37, 256, 728), (19, 728, 728),
               (10, 1536, 2048)]
SMOKE_PW1X1 = [(35, 192, 64), (17, 768, 192), (8, 2048, 448)]


def _f32_smoke_cases():
    for site in SMOKE_SEP2D:
        yield "sep2d", site, _sep2d(site, torch.float32)
    for site in SMOKE_PW1X1:
        yield "pw1x1", site, _pw1x1(site, torch.float32)


F32_SMOKE = list(_f32_smoke_cases())


@pytest.mark.parametrize("kernel,site,plan", F32_SMOKE,
                         ids=["%s-%s" % (k, _site_id(s))
                              for k, s, _ in F32_SMOKE])
def test_float32_plan_rounds_fill_and_recompute(kernel, site, plan):
    """The float32 plan at chip_smoke's shapes: units over the SMs in
    ``waves`` (one persistent block an SM) and ``fill`` (the busy share of the
    rounds), a note wherever the last round is under 80% full or the grid
    under one wave; sep2d's depthwise resident (recompute 1) wherever the
    layout fits, else streamed once per N tile with the reason given."""
    hw, cin, cout = site
    rows = BATCH * hw * hw
    assert plan.body == "simt_f32" and plan.blocks <= kernels.SMS
    tiles_m = -(-rows // plan.bm)
    tiles_n = -(-cout // plan.bn)
    assert plan.units == tiles_m * plan.groups * plan.splits
    rounds = -(-plan.units // kernels.SMS)
    assert plan.waves == pytest.approx(plan.units / kernels.SMS)
    assert plan.fill == pytest.approx(plan.units / (kernels.SMS * rounds))
    if plan.fill < 0.8:
        assert "fill" in plan.note or "busy" in plan.note
    if plan.blocks < kernels.SMS:
        assert plan.note
    if kernel == "pw1x1":
        assert plan.recompute == 0 and plan.groups == tiles_n
        return
    if plan.layout == "resident":
        assert plan.recompute == plan.groups <= 2
        assert plan.stages <= plan.chunks
    else:
        assert plan.layout == "streaming"
        assert plan.recompute == plan.groups == tiles_n
        assert "resident" in plan.note and str(cin) in plan.note
    # Xception's middle flow keeps its depthwise resident; 1536 channels
    # at 10×10 do not fit beside the ring
    expected = "streaming" if cin == 1536 else "resident"
    assert plan.layout == expected


@pytest.mark.parametrize("cin,cout", [(728, 728), (728, 100), (22, 13),
                                      (37, 2048), (1536, 24)])
@pytest.mark.parametrize("kernel", ["sep2d", "pw1x1"])
def test_float32_plan_covers_ragged_widths(kernel, cin, cout):
    """Ragged Cin (a K tail of zero-filled columns) and Cout (a last N
    tile partly stored): the chunks cover Cin, the N tiles Cout, every
    N-tile group is non-empty, a resident D holds every chunk."""
    if kernel == "sep2d":
        plan = kernels.plan_sep2d(1, 9, 7, cin, cout, torch.float32)
    else:
        plan = kernels.plan_pw1x1(63, cin, cout, torch.float32)
    assert plan.body == "simt_f32"
    assert plan.chunks == -(-cin // 16) and plan.chunk == 16
    tiles_n = -(-cout // plan.bn)
    per_group = -(-tiles_n // plan.groups)
    assert (plan.groups - 1) * per_group < tiles_n
    assert plan.smem <= kernels.SMEM_LIMIT
    if plan.layout == "resident":
        assert plan.stages <= plan.chunks
