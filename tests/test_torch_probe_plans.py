"""The launch plans of the ``dw2d`` and ``sep2d_probe`` kernels, on the CPU.

``plan_dw2d`` and ``plan_sep2d_probe``
(``sparkdl_tpu_torch/experiments/probe.py``) are pure functions of a
call's rows and channels: the tile, the rings, the cluster, the blocks,
the shared memory, how often the depthwise of a (row, channel) is computed
and the pw bytes read per call. The C launchers refuse a plan they cannot
run, so these tests hold the plans at batches of 1, 2, 3 (a ragged number
of 128-row tiles) and 128 images: tiles cover every row and channel once,
halos reach W + 1 rows each side, TMA boxes stay within 256 rows of a
1,456-byte stride, shared memory fits.

Then ``dw2d``'s tile walk is emulated in PyTorch on the CPU as the kernel
runs it: zero-filled halo boxes as TMA returns them, the sliding window
of each thread's run of rows, masks stepped from ``p % P_PAD``, a masked
tap skipped. It must equal ``plain_dw2d`` bit for bit across tile, image
and tensor borders.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.experiments import probe as tp

BATCHES = [1, 2, 3, 128]
PLANS = {"dw2d": tp.plan_dw2d, "sep2d_probe": tp.plan_sep2d_probe}
ROW_STRIDE = tp.C * 2  # bytes between rows of x, out and pw


def _plan(kernel, b):
    return PLANS[kernel](b * tp.P_PAD)


def _tiles(plan):
    return [tile for block in range(plan.blocks)
            for tile in tp.tile_walk(plan, block)]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_tiles_cover_every_row_and_channel_once(kernel, b):
    rows = b * tp.P_PAD
    plan = _plan(kernel, b)
    walked = Counter(_tiles(plan))
    assert max(walked.values()) == 1  # no block repeats another's tile
    width = plan.chunk if kernel == "dw2d" else plan.chunks * plan.chunk
    live = {(r0, c0) for r0, c0 in walked if r0 < rows}
    assert live == {(r0, c0) for r0 in range(0, rows, plan.bm)
                    for c0 in range(0, tp.C, width)}
    assert plan.row_tiles == -(-rows // plan.bm)
    assert plan.chunks * plan.chunk >= tp.C > (plan.chunks - 1) * plan.chunk
    # sep2d_probe rounds the row tiles up to whole clusters: the extra
    # tiles lie past the last row (computed, never stored)
    assert len(walked) - len(live) < plan.cluster
    if b < 128:  # every (row, channel) once, element by element
        cover = np.zeros((rows, tp.C), np.uint8)
        for r0, c0 in live:
            cover[r0:r0 + plan.bm, c0:c0 + width] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_halo_and_tma_boxes(kernel, b):
    plan = _plan(kernel, b)
    # the tile's rows and the W + 1 rows its taps reach on each side
    assert plan.halo_rows == plan.bm + 2 * (tp.W + 1)
    assert plan.halo_rows <= tp.TMA_BOX_MAX
    assert plan.chunk * 2 == 128  # one box row: 64 bf16, the swizzle span
    assert plan.row_stride == ROW_STRIDE == 1456 and ROW_STRIDE % 16 == 0
    assert 2 <= plan.halo_slots <= 4
    if kernel == "sep2d_probe":  # pw stages: boxes of 64 K rows x 64 N
        assert plan.bn % plan.chunk == 0 and plan.chunk <= tp.TMA_BOX_MAX
        assert 2 <= plan.stages <= 4 and plan.chunks <= plan.a_slots <= 16


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_shared_memory_and_blocks(kernel, b):
    plan = _plan(kernel, b)
    assert plan.smem <= kernels.SMEM_LIMIT  # 227 KB a block
    assert plan.smem * plan.blocks_per_sm <= tp.SM_SMEM  # 228 KB an SM
    assert 0 < plan.blocks <= plan.blocks_per_sm * kernels.SMS
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks <= plan.tiles  # persistent: no block idles
    if kernel == "sep2d_probe":
        assert plan.smem == tp.sep2d_probe_smem(plan.a_slots, plan.stages,
                                                plan.halo_slots)
    else:
        assert plan.smem == (tp.TILE_ALIGN
                             + plan.halo_slots * plan.halo_rows * 128)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_depthwise_once_and_pw_bytes(kernel, b):
    plan = _plan(kernel, b)
    assert plan.recompute == 1
    if kernel == "dw2d":
        assert plan.pw_bytes == 0
        return
    # the depthwise of a tile stays resident over every pass
    assert plan.a_slots >= plan.chunks and plan.passes > 1
    # each cluster of row tiles reads pw once
    groups = -(-plan.row_tiles // plan.cluster)
    assert plan.tiles == groups * plan.cluster
    assert plan.pw_bytes == groups * tp.C * tp.C * 2


def test_plans_are_deterministic():
    for kernel, fn in PLANS.items():
        first = [fn(b * tp.P_PAD) for b in BATCHES]
        fn.cache_clear()
        assert [fn(b * tp.P_PAD) for b in BATCHES] == first, kernel
        assert [fn(b * tp.P_PAD).row() for b in BATCHES] \
            == [p.row() for p in first]


def test_a_ring_that_does_not_fit_is_refused():
    with pytest.raises(ValueError, match="no ring fits"):
        tp.plan_sep2d_probe(368, c=2048)


# ---------------------------------------------------------------------------
# dw2d's tile walk, emulated
# ---------------------------------------------------------------------------

_RUNS = 16  # runs of rows a tile: 256 threads over 16 four-channel quads


def _tap_masks(row0, n):
    """Bit 3 (dy + 1) + dx + 1 of rows row0 .. row0 + n - 1: tap (dy, dx)
    inside the image, (h, w) stepped from the first row's as the kernel
    steps them."""
    p = row0 % tp.P_PAD
    h, w = divmod(p, tp.W)
    masks = []
    for _ in range(n):
        dx = (1 if w >= 1 else 0) | 2 | (4 if w <= tp.W - 2 else 0)
        masks.append((dx if 1 <= h <= tp.H else 0)
                     | (dx << 3 if h <= tp.H - 1 else 0)
                     | (dx << 6 if h <= tp.H - 2 else 0))
        w += 1
        if w == tp.W:
            w, h = 0, h + 1
        p += 1
        if p == tp.P_PAD:
            p, h, w = 0, 0, 0
    return masks


def _emulate_dw2d(x2d: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    rows, c = x2d.shape
    plan = tp.plan_dw2d(rows)
    run = plan.bm // _RUNS
    xf, kf = x2d.float(), k9.float()
    out = torch.full((rows, c), float("nan"))
    for block in range(plan.blocks):
        for row0, c0 in tp.tile_walk(plan, block):
            # the TMA box: zeros outside the tensor
            halo = torch.zeros(plan.halo_rows, plan.chunk)
            top = row0 - tp.W - 1
            r_lo, r_hi = max(top, 0), min(top + plan.halo_rows, rows)
            c_hi = min(c0 + plan.chunk, c)
            halo[r_lo - top:r_hi - top, :c_hi - c0] = xf[r_lo:r_hi, c0:c_hi]
            k = torch.zeros(9, plan.chunk)
            k[:, :c_hi - c0] = kf[:, c0:c_hi]
            # all runs of the tile at once: run g holds rows g * run ..
            first = torch.arange(_RUNS) * run
            centre = first + tp.W + 1
            masks = torch.tensor([_tap_masks(row0 + int(f), run)
                                  for f in first])  # (runs, run)
            win = [[halo[centre + (d - 1) * tp.W - 1],
                    halo[centre + (d - 1) * tp.W], None] for d in range(3)]
            for i in range(run):
                for d in range(3):
                    win[d][2] = halo[centre + i + (d - 1) * tp.W + 1]
                acc = torch.zeros(_RUNS, plan.chunk)
                for j in range(9):
                    on = ((masks[:, i] >> j) & 1).bool().unsqueeze(1)
                    acc = torch.where(on, acc + win[j // 3][j % 3] * k[j],
                                      acc)
                dst = row0 + first + i
                keep = dst < rows
                out[dst[keep], c0:c_hi] = acc[keep, :c_hi - c0]
                for d in range(3):
                    win[d][0], win[d][1] = win[d][1], win[d][2]
    return out.to(x2d.dtype)


def test_dw2d_tile_walk_matches_plain_bit_for_bit():
    """Three images (1,104 rows: the last 128-row tile ragged, image
    borders inside tiles), the dead pad rows included."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, tp.H, tp.W, tp.C))
                         .astype(np.float32)).to(torch.bfloat16)
    k9 = torch.from_numpy((rng.normal(size=(9, tp.C)) * 0.2)
                          .astype(np.float32)).to(torch.bfloat16)
    x2 = tp.pad_rows(x)
    ours = _emulate_dw2d(x2, k9)
    ref = tp.plain_dw2d(x2, k9)
    assert not torch.isnan(ours.float()).any()  # every element written
    assert torch.equal(ours, ref)
    dead = ref.float().reshape(3, tp.P_PAD, tp.C)[:, tp.P:]
    assert float(dead.abs().max()) > 0.0
