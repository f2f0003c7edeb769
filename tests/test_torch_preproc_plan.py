"""The launch plan and tables of the port's ``preproc_resize`` kernel, on the CPU.

``plan_preproc`` and ``preproc_tables`` (``sparkdl_tpu_torch/core/
kernels.py``) are pure functions of a call's shape and dtypes: bands of
output rows, one block each; the runs of source rows each band stages in
shared memory; the block's shared-memory layout; the row and column taps
the kernel reads. The C launcher checks the layout and refuses one it
cannot run, so these tests hold the plans at the featurize path's shapes
and at the edges (ragged rows, identity, one output row, a steep
downscale, a 1×1 source): every output row in exactly one band, every
tap row in its band's staged runs, shared memory under the block's
limit, the grid the bands. Then a numpy walk of the tables, as the
kernel walks them (staging slots shifted by their address modulo 16, the
vertical pass once per tapped source column, the horizontal pass), must
equal the exact-order resize bit for bit and ``plain_preproc`` within
the float32 kernel tolerance.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import cuda_build, kernels
from sparkdl_tpu_torch.experiments.preproc_breakdown import exact_order

#: (B, H, W, C, TH, TW): the featurize path's two resized sources, then
#: a row of 51 bytes, a downscale, a steep downscale, a 1×1 source
SHAPES = [(16, 256, 256, 3, 299, 299), (16, 512, 384, 3, 299, 299),
          (3, 13, 17, 3, 29, 23), (2, 40, 36, 3, 32, 32),
          (2, 600, 600, 3, 3, 3), (2, 1, 1, 3, 299, 299)]
PAIRS = [(i, o) for i in (torch.uint8, torch.float32, torch.bfloat16)
         for o in (torch.float32, torch.bfloat16)]
ITEM = {torch.uint8: 1, torch.bfloat16: 2, torch.float32: 4}


def _plan(shape, pair, **kw):
    return kernels.plan_preproc(*shape, *pair, **kw)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}->{p[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bands_cover_every_output_row_once(shape, pair):
    plan = _plan(shape, pair)
    th = shape[4]
    covered = np.zeros(th, np.int64)
    for k in range(plan.bands):
        begin, end = plan.band(k)
        assert 0 <= begin < end <= th and end - begin <= plan.band_rows
        covered[begin:end] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}->{p[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_tap_row_lies_in_its_bands_staged_runs(shape, pair):
    b, h, w, c, th, tw = shape
    plan = _plan(shape, pair)
    assert plan.staged, plan.note
    assert len(plan.runs) == plan.bands
    assert plan.run_stride == max(len(band) for band in plan.runs)
    ytaps = kernels._resize_taps(h, th)[0]
    row_bytes = w * c * ITEM[pair[0]]
    for k, band in enumerate(plan.runs):
        begin, end = plan.band(k)
        staged = {r for first, n, _ in band for r in range(first, first + n)}
        assert set(ytaps[begin:end].ravel().tolist()) <= staged
        assert all(0 <= first and first + n <= h for first, n, _ in band)
        # slots in order, 16-byte aligned, room for the address shift
        end_of_last = 0
        for first, n, offset in band:
            assert offset % 16 == 0 and offset >= end_of_last
            end_of_last = offset + -(-n * row_bytes // 16) * 16 + 16
        assert end_of_last <= plan.staged_bytes


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}->{p[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shared_memory_fits_and_the_grid_is_the_bands(shape, pair):
    b, h, w, c, th, tw = shape
    plan = _plan(shape, pair)
    r = plan.band_rows
    # the C launcher's checks
    assert plan.src_off % 16 == plan.t_off % 16 == plan.out_off % 16 == 0
    assert plan.src_off >= 16 + 16 * r
    assert plan.t_off == plan.src_off + plan.staged_bytes
    assert plan.out_off >= plan.t_off + 4 * r * plan.nxc
    assert plan.smem >= plan.out_off + 16 + r * tw * c * ITEM[pair[1]]
    assert plan.smem <= kernels.SMEM_LIMIT
    assert 1 <= r <= 256  # a band row a thread fills its record
    assert plan.grid == (-(-th // r), b, 1) and plan.blocks == plan.bands * b
    columns = len(np.unique(kernels._resize_taps(w, tw)[0]))
    assert plan.dense == (columns == w) and plan.nxc == columns * c


def test_plans_at_the_featurize_shapes():
    """The 256×256 and 512×384 sources of the featurize path: bands of
    four rows staged whole, four or more blocks an SM's worth of shared
    memory, every source column tapped (an upscale and a mild
    downscale), a wave of blocks at least; a steep downscale stages two
    rows an output row."""
    for shape in SHAPES[:2]:
        plan = _plan(shape, (torch.uint8, torch.float32))
        assert plan.staged and plan.dense and plan.note == ""
        assert plan.smem <= kernels.SMEM_LIMIT // 4
        assert plan.blocks >= 2 * kernels.SMS
        assert all(len(band) == 1 for band in plan.runs)
    steep = _plan(SHAPES[4], (torch.uint8, torch.float32))
    assert steep.band_rows == 1 and not steep.dense
    assert [[n for _, n, _ in band] for band in steep.runs] == [[2]] * 3


def test_rows_that_do_not_fit_are_read_from_device_memory():
    """Two float32 rows of 15,000 × 4 (480 KB) cannot be staged: the
    vertical pass reads the image, and the rest still fits."""
    plan = kernels.plan_preproc(1, 2, 15000, 4, 1, 5, torch.float32,
                                torch.float32)
    assert not plan.staged and plan.runs == () and plan.staged_bytes == 0
    assert plan.smem <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kernels.plan_preproc(1, 2, 2, 4, 2, 20000, torch.uint8,
                             torch.float32)


@pytest.mark.parametrize("band_rows", [1, 3, 16])
def test_pinned_band_heights(band_rows):
    plan = _plan(SHAPES[0], (torch.uint8, torch.float32),
                 band_rows=band_rows)
    assert plan.band_rows == band_rows and plan.staged
    assert plan.bands == -(-299 // band_rows)


def walk_tables(x: np.ndarray, plan, th: int, tw: int,
                base: int) -> np.ndarray:
    """The kernel's walk of ``preproc_tables`` in numpy, the input at
    byte address ``base``: each band's runs staged at their slots
    (shifted by their address modulo 16), each band row's tap offsets
    from ``rowtab`` and the runs, the vertical pass over ``vsrc``, the
    horizontal pass over ``htab``."""
    b, h, w, c = x.shape
    tabs = kernels.preproc_tables(plan, h, w, c, tw)
    item, wc = x.itemsize, w * c
    out = np.zeros((b, th, tw * c), np.float32)
    for img in range(b):
        image = x[img].reshape(-1)
        img_addr = base + img * h * wc * item
        for k in range(plan.bands):
            begin, end = plan.band(k)
            if plan.staged:
                area = np.full(plan.staged_bytes // item, np.nan, np.float32)
                first = k * plan.run_stride
                count = tabs["runs"][first, 3]
                for y0, n, offset, _ in tabs["runs"][first:first + count]:
                    a = img_addr + y0 * wc * item
                    at = (offset + a % 16) // item
                    area[at:at + n * wc] = image[y0 * wc:(y0 + n) * wc]
            t = np.zeros((end - begin, plan.nxc), np.float32)
            for r, oy in enumerate(range(begin, end)):
                y0, y1, k0, k1 = tabs["rowtab"][oy]
                rows = []
                for y, run in ((y0, k0), (y1, k1)):
                    if plan.staged:
                        fy, _, offset, _ = tabs["runs"][first + run]
                        a = img_addr + fy * wc * item
                        at = (offset + a % 16) // item + (y - fy) * wc
                        rows.append(area[at:at + wc])
                    else:
                        rows.append(image[y * wc:(y + 1) * wc].astype(
                            np.float32))
                v = (np.arange(wc) if plan.dense else tabs["vsrc"])
                wy0, wy1 = tabs["ywt"][oy]
                t[r] = wy0 * rows[0][v] + wy1 * rows[1][v]
            h0, h1 = tabs["htab"][:, 0], tabs["htab"][:, 1]
            wx0 = tabs["htab"][:, 2].view(np.float32)
            wx1 = tabs["htab"][:, 3].view(np.float32)
            out[img, begin:end] = wx0 * t[:, h0] + wx1 * t[:, h1]
    assert np.isfinite(out).all(), "a tap read outside its staged run"
    return out.reshape(b, th, tw, c)


@pytest.mark.parametrize("base", [0, 4, 12])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", [(3, 13, 17, 3, 29, 23),
                                   (1, 40, 36, 4, 32, 32),
                                   (2, 17, 13, 1, 17, 13),
                                   (3, 20, 30, 3, 1, 7),
                                   (1, 600, 60, 3, 3, 3),
                                   (1, 2, 15000, 4, 1, 5),
                                   (2, 1, 1, 3, 9, 7)], ids=str)
def test_the_tables_walked_as_the_kernel_walks_them(shape, in_dtype, base):
    b, h, w, c, th, tw = shape
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, size=(b, h, w, c)).astype(np.uint8)
    if in_dtype == torch.float32:
        x = (x.astype(np.float32) - 127.5) / 3.0
    plans = [_plan(shape, (in_dtype, torch.float32))]
    plans += [_plan(shape, (in_dtype, torch.float32), band_rows=r)
              for r in (1, 3)]
    ref = exact_order(torch.from_numpy(x), th, tw, torch.float32).numpy()
    plain = kernels.plain_preproc(torch.from_numpy(x), (th, tw),
                                  torch.float32).numpy()
    for plan in plans:
        got = walk_tables(x, plan, th, tw, base)
        np.testing.assert_array_equal(got, ref)
    assert np.abs(ref - plain).max() <= 1e-5 * max(1.0, np.abs(plain).max())


def test_the_wrapper_passes_what_the_c_launcher_takes():
    """The ctypes signature of ``sparkdl_preproc_resize`` is the C one:
    a pointer for each pointer, an int for each int, the stream last."""
    source = (cuda_build.CSRC / "preproc_resize.cu").read_text()
    params = re.search(r'extern "C" int sparkdl_preproc_resize\((.*?)\)',
                       source, re.S).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kernels._PREPROC_ARGTYPES == want
