"""Depthwise and sepconv probes against the library's grouped conv, on the card.

The counterpart of ``experiments/pallas_probe.py``, which measured on the
TPU what bounds Xception's depthwise-separable convs. The same three
probes are hand-written CUDA kernels here (``csrc/probes.cu``):

1. :func:`fma9` — nine multiply-adds per element on a resident tile, no
   shifts: the ceiling of any 3×3 stencil;
2. :func:`dw2d` — the real 3×3 SAME depthwise on the padded row-major
   layout, one row shift ``W·dy + dx`` per tap, masked from the row's
   (h, w);
3. :func:`sep2d_probe` — relu → depthwise → 1×1 product → affine, the
   depthwise kept on chip.

Beside each wrapper is its plain PyTorch version (:func:`plain_fma9`,
:func:`plain_dw2d`, :func:`plain_sep2d_probe`), which a wrapper takes only
for a CPU tensor, and :data:`launches` counts the kernels' launches.
:func:`plan_dw2d` and :func:`plan_sep2d_probe` are the launch plans of
the two kernels that stage their halos by TMA (tiles, rings, cluster,
blocks, shared memory, how often a depthwise value is computed, pw bytes
a call); the C launchers check them, and :func:`tile_walk` lists the
tiles a block walks. The
plain versions and the kernels round alike: each tap's product and each
partial sum in float32, in tap order, without FMA contraction, rounded to
bf16 once. :func:`library_fma9` (one ``einsum``), :func:`library_dw` and
:func:`library_sep` (the library's grouped-conv chains on the 4-D layout)
compute the same functions with library calls, timed as yardsticks only.

Shapes: Xception's middle flow, B = 128 images of 19×19×728, bf16; each
image takes ``P_PAD`` = 368 rows (361 positions and 7 dead pad rows, which
every probe computes too).

Run on the card: ``python -m sparkdl_tpu_torch.experiments.probe``. Each
probe is timed by chaining it on its own output k = 2 and k = 34 times
inside one CUDA graph per k (no host launch overhead, as the TPU script's
``fori_loop``), best of ``repeats`` CUDA-event timings per k; the slope is
the time per application. A wrapper called while a graph is captured
launches nothing: it counts the call in :data:`captured`, and each replay
adds the graph's captured calls to :data:`launches`.
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.core import cuda_build
from sparkdl_tpu_torch.core.kernels import (SMEM_LIMIT, SMS, _check,
                                            _on_card, _raise_on_error)

B, H, W, C = 128, 19, 19, 728
P = H * W                 # 361 positions per image
P_PAD = 368               # rows per image: the TPU probe's sublane padding

DW_FLOPS_APP = P * C * 9 * 2          # one dw application, per image
PW_FLOPS_APP = P * C * C * 2          # one pw application, per image

#: Kernel launches on the card since the last :func:`reset_launches`
#: (a graph replay's launches included).
launches: Dict[str, int] = {"fma9": 0, "dw2d": 0, "sep2d_probe": 0}
#: Wrapper calls recorded into the CUDA graph being captured.
captured: Dict[str, int] = dict.fromkeys(launches, 0)

# (dy, dx) of tap j, row-major: the order of k9's rows and of every sum
_TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) → (b·P_PAD, C): image positions row-major, each image
    zero-padded to P_PAD rows."""
    b = x.shape[0]
    out = x.new_zeros((b, P_PAD, C))
    out[:, :P] = x.reshape(b, P, C)
    return out.reshape(b * P_PAD, C)


def unpad_rows(x2: torch.Tensor, b: int) -> torch.Tensor:
    return x2.reshape(b, P_PAD, C)[:, :P].reshape(b, H, W, C)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def plain_fma9(x2d: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """Σ_{i<9} x·k[i] per channel, in float32, rounded to x's type once."""
    xf, kf = x2d.float(), k9.float()
    acc = xf * kf[0]
    for i in range(1, 9):
        acc = acc + xf * kf[i]
    return acc.to(x2d.dtype)


def _shift_rows(a: torch.Tensor, s: int) -> torch.Tensor:
    """``out[r] = a[r + s]``, zero where r + s falls outside ``a``."""
    out = torch.zeros_like(a)
    n = a.shape[0]
    if s >= 0:
        out[:n - s] = a[s:]
    else:
        out[-s:] = a[:n + s]
    return out


def plain_dw2d(x2d: torch.Tensor, k9: torch.Tensor, *,
               relu_in: bool = False) -> torch.Tensor:
    """3×3 SAME depthwise on the padded row-major layout, as the TPU
    probe's ``_dw_rows`` defines it, dead rows included: tap (dy, dx) reads
    row r + W·dy + dx where (h + dy, w + dx) lies in the image, with
    (h, w) = divmod(r % P_PAD, W). Products and sums in float32 in tap
    order, rounded to x's type once."""
    xf, kf = x2d.float(), k9.float()
    if relu_in:
        xf = torch.relu(xf)
    p = torch.arange(x2d.shape[0], device=x2d.device) % P_PAD
    h, w = p // W, p % W
    acc = torch.zeros_like(xf)
    for j, (dy, dx) in enumerate(_TAPS):
        valid = ((h + dy >= 0) & (h + dy <= H - 1)
                 & (w + dx >= 0) & (w + dx <= W - 1)).unsqueeze(1)
        acc = acc + torch.where(valid, _shift_rows(xf, W * dy + dx) * kf[j],
                                0.0)
    return acc.to(x2d.dtype)


def plain_sep2d_probe(x2d, k9, pw, sc, sh) -> torch.Tensor:
    """relu → :func:`plain_dw2d` (rounded to x's type) → the product with
    ``pw`` in float32 → ``y·sc + sh`` in float32 → x's type."""
    t = plain_dw2d(x2d, k9, relu_in=True)
    y = torch.matmul(t.float(), pw.float())
    y = y * sc.float().reshape(-1) + sh.float().reshape(-1)
    return y.to(x2d.dtype)


#: sep2d_probe's kernel sums the product in another order than the plain
#: version's float32 matmul, so its bf16 result may round one step apart:
#: |Δ| ≤ 2^-7·|ref| (one bf16 ulp) + 1e-3, element by element.
SEP_ULP_REL, SEP_ABS = 2.0 ** -7, 1e-3


def matches_plain(name: str, y: torch.Tensor, ref: torch.Tensor) -> bool:
    """Whether probe kernel ``name``'s output ``y`` agrees with its plain
    version's ``ref``: bit for bit for ``fma9`` and ``dw2d``, which round
    alike; within :data:`SEP_ULP_REL` and :data:`SEP_ABS` for
    ``sep2d_probe``."""
    if y.shape != ref.shape or y.dtype != ref.dtype:
        return False
    if name in ("fma9", "dw2d"):
        return torch.equal(y, ref)
    yf, rf = y.float(), ref.float()
    return bool(((yf - rf).abs()
                 <= SEP_ULP_REL * rf.abs() + SEP_ABS).all())


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

CHUNK = 64            # channels a tile or depthwise chunk holds (128 bytes)
ROW_BYTES = CHUNK * 2
TILE_ALIGN = 1024
TMA_BOX_MAX = 256     # rows of one TMA box
#: Shared memory one SM holds for its blocks, in bytes.
SM_SMEM = 233472
_DW_BM, _DW_SLOTS, _DW_BLOCKS_PER_SM = 128, 3, 2
_SEP_BM, _SEP_BN, _SEP_CLUSTER = 64, 256, 2
_SEP_MAX_A_SLOTS, _SEP_MAX_STAGES, _SEP_MAX_HALO_SLOTS = 16, 4, 4
#: (A slots, pw stages, halo slots) of sep2d_probe, in the order tried.
SEP_RINGS = ((12, 3, 2), (16, 2, 2), (12, 2, 3), (12, 2, 2))


@dataclass(frozen=True)
class ProbePlan:
    """How one :func:`dw2d` or :func:`sep2d_probe` call runs.

    ``bm`` rows × ``bn`` channels a tile (for ``sep2d_probe``, ``bn``
    output channels a pass over the resident depthwise), input channels in
    ``chunks`` chunks of ``chunk``, ``passes`` passes over the output
    channels; ``row_tiles`` row tiles, ``tiles`` tiles walked (for
    ``sep2d_probe`` the row tiles rounded up to whole clusters: a tile past
    the last row is computed, never stored). Each TMA halo box holds
    ``halo_rows`` rows (the tile and ``W + 1`` on each side), ``halo_slots``
    in flight; ``a_slots`` depthwise chunks resident and ``stages`` pw
    stages (``sep2d_probe``). ``blocks`` persistent blocks in clusters of
    ``cluster``, ``blocks_per_sm`` a SM, ``smem`` bytes each.
    ``recompute``: how often the depthwise of one (row, channel) is
    computed; ``pw_bytes``: pw bytes read from L2 per call;
    ``row_stride``: bytes between rows in the TMA tensor maps."""

    body: str
    bm: int
    bn: int
    chunk: int
    chunks: int
    passes: int
    row_tiles: int
    tiles: int
    halo_rows: int
    halo_slots: int
    a_slots: int
    stages: int
    cluster: int
    blocks: int
    blocks_per_sm: int
    smem: int
    recompute: int
    pw_bytes: int
    row_stride: int

    def row(self) -> Dict[str, object]:
        """The plan as a JSON row."""
        return {"body": self.body, "tile": [self.bm, self.bn],
                "chunks": self.chunks, "passes": self.passes,
                "row_tiles": self.row_tiles, "tiles": self.tiles,
                "halo_rows": self.halo_rows, "halo_slots": self.halo_slots,
                "a_slots": self.a_slots, "stages": self.stages,
                "cluster": self.cluster, "blocks": self.blocks,
                "blocks_per_sm": self.blocks_per_sm, "smem": self.smem,
                "recompute": self.recompute, "pw_bytes": self.pw_bytes,
                "row_stride": self.row_stride}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan_dw2d(rows: int, c: int = C) -> ProbePlan:
    """:func:`dw2d`'s plan: tiles of 128 rows × 64 channels, the chunks
    of a row tile neighbours in the walk, a halo of 128 + 2·(W + 1) rows
    staged by one TMA load, three halos in flight, two persistent blocks
    a SM."""
    chunks = _cdiv(c, CHUNK)
    row_tiles = _cdiv(rows, _DW_BM)
    tiles = row_tiles * chunks
    halo_rows = _DW_BM + 2 * (W + 1)
    smem = TILE_ALIGN + _DW_SLOTS * halo_rows * ROW_BYTES
    return ProbePlan("tma_halo", _DW_BM, CHUNK, CHUNK, chunks, 1, row_tiles,
                     tiles, halo_rows, _DW_SLOTS, 0, 0, 1,
                     min(tiles, _DW_BLOCKS_PER_SM * SMS), _DW_BLOCKS_PER_SM,
                     smem, 1, 0, c * 2)


def sep2d_probe_smem(a_slots: int, stages: int, halo_slots: int,
                     c: int = C) -> int:
    """Shared memory of a :func:`sep2d_probe` block: the A slots (64 rows
    × 64 channels), the pw stages (64 × 256), halos, the affine's scale
    and shift as float, and the barriers, as ``csrc/probes.cu`` lays them
    out."""
    halo = (_SEP_BM + 2 * (W + 1)) * ROW_BYTES
    affine = 2 * _cdiv(c, _SEP_BN) * _SEP_BN * 4
    barriers = (2 * _SEP_MAX_STAGES + 2 * _SEP_MAX_A_SLOTS
                + _SEP_MAX_HALO_SLOTS) * 8
    return (TILE_ALIGN + a_slots * _SEP_BM * ROW_BYTES
            + stages * _SEP_BN * ROW_BYTES + halo_slots * halo
            + affine + barriers)


@functools.lru_cache(maxsize=256)
def plan_sep2d_probe(rows: int, c: int = C,
                     ring: Optional[Tuple[int, int, int]] = None
                     ) -> ProbePlan:
    """:func:`sep2d_probe`'s plan: 64-row tiles whose depthwise (all
    ``c`` input channels, in chunks of 64) stays resident while a
    consumer warpgroup walks the output channels in passes of 256, so it
    is computed once per (row, channel); the first ring of
    :data:`SEP_RINGS` (or ``ring``) that fits one block a SM; clusters of
    two blocks that share each pw stage by TMA multicast, so L2 serves pw
    once per pair of row tiles."""
    chunks = _cdiv(c, CHUNK)
    row_tiles = _cdiv(rows, _SEP_BM)
    groups = _cdiv(row_tiles, _SEP_CLUSTER)
    for a_slots, stages, halo_slots in ((ring,) if ring else SEP_RINGS):
        smem = sep2d_probe_smem(a_slots, stages, halo_slots, c)
        if a_slots >= chunks and smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"sep2d_probe: no ring fits C = {c}")
    blocks = min(groups, SMS // _SEP_CLUSTER) * _SEP_CLUSTER
    return ProbePlan("wgmma", _SEP_BM, _SEP_BN, CHUNK, chunks,
                     _cdiv(c, _SEP_BN), row_tiles, groups * _SEP_CLUSTER,
                     _SEP_BM + 2 * (W + 1), halo_slots, a_slots, stages,
                     _SEP_CLUSTER, blocks, 1, smem,
                     1 if a_slots >= chunks else _cdiv(c, _SEP_BN),
                     groups * c * c * 2, c * 2)


def tile_walk(plan: ProbePlan, block: int):
    """The tiles ``block`` walks, in order, as the kernels compute them:
    ``(first row, first channel)`` for :func:`dw2d` (the chunks of a row
    tile one after another), ``(first row, 0)`` for :func:`sep2d_probe`
    (all channels; the cluster's blocks take consecutive row tiles)."""
    if plan.body == "tma_halo":
        return [((t // plan.chunks) * plan.bm, (t % plan.chunks) * plan.chunk)
                for t in range(block, plan.tiles, plan.blocks)]
    cid, rank = divmod(block, plan.cluster)
    clusters = plan.blocks // plan.cluster
    groups = plan.tiles // plan.cluster
    return [((g * plan.cluster + rank) * plan.bm, 0)
            for g in range(cid, groups, clusters)]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "sparkdl_fma9": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p],
    "sparkdl_dw2d": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "sparkdl_sep2d_probe": [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _probe_fn(symbol: str):
    fn = getattr(cuda_build.library("probes"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _check_probe(x2d: torch.Tensor, k9: torch.Tensor, kernel: str) -> None:
    """The layout every probe kernel takes: (b·P_PAD, C) bf16 rows and
    (9, C) bf16 taps, contiguous, on x's device."""
    if x2d.dim() != 2:
        raise ValueError(f"{kernel}: x2d must be (rows, C), got "
                         f"{tuple(x2d.shape)}")
    _check(x2d, "x2d", x2d.device, torch.bfloat16, (x2d.shape[0], C))
    if x2d.shape[0] % P_PAD:
        raise ValueError(f"{kernel}: {x2d.shape[0]} rows is not a whole "
                         f"number of {P_PAD}-row images")
    _check(k9, "k9", x2d.device, torch.bfloat16, (9, C))


def _launch(kernel: str, x2d: torch.Tensor, inputs, dims):
    """``sparkdl_<kernel>(*inputs, out, *dims, stream)`` into a new
    tensor like x2d."""
    out = torch.empty_like(x2d)
    if out.numel() == 0:
        return out
    fn = _probe_fn(f"sparkdl_{kernel}")
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(), *dims,
                 stream)
    _raise_on_error(err, kernel)
    if torch.cuda.is_current_stream_capturing():
        captured[kernel] += 1  # runs at each replay of the graph
    else:
        launches[kernel] += 1
    return out


def fma9(x2d: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """``Σ_{i<9} x·k[i]`` per channel: (b·P_PAD, C) bf16 → same."""
    if not _on_card(x2d, "fma9"):
        return plain_fma9(x2d, k9)
    _check_probe(x2d, k9, "fma9")
    return _launch("fma9", x2d, (x2d, k9), (x2d.shape[0], C))


def dw2d(x2d: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """The 3×3 SAME depthwise of :func:`plain_dw2d`: (b·P_PAD, C) bf16 →
    same, every row computed."""
    if not _on_card(x2d, "dw2d"):
        return plain_dw2d(x2d, k9)
    _check_probe(x2d, k9, "dw2d")
    plan = plan_dw2d(x2d.shape[0])
    return _launch("dw2d", x2d, (x2d, k9),
                   (x2d.shape[0], C, P_PAD, H, W, plan.bm, plan.halo_slots,
                    plan.blocks))


def sep2d_probe(x2d, k9, pw, sc, sh) -> torch.Tensor:
    """relu → depthwise → ``·pw`` (float32 accumulate) → ``y·sc + sh``:
    (b·P_PAD, C) bf16 → same. ``pw`` is (C, C), ``sc``/``sh`` (1, C) or
    (C,), all bf16."""
    if not _on_card(x2d, "sep2d_probe"):
        return plain_sep2d_probe(x2d, k9, pw, sc, sh)
    _check_probe(x2d, k9, "sep2d_probe")
    _check(pw, "pw", x2d.device, torch.bfloat16, (C, C))
    sc, sh = sc.reshape(C), sh.reshape(C)
    _check(sc, "sc", x2d.device, torch.bfloat16, (C,))
    _check(sh, "sh", x2d.device, torch.bfloat16, (C,))
    plan = plan_sep2d_probe(x2d.shape[0])
    return _launch("sep2d_probe", x2d, (x2d, k9, pw, sc, sh),
                   (x2d.shape[0], C, P_PAD, H, W, plan.a_slots, plan.stages,
                    plan.halo_slots, plan.cluster, plan.blocks))


# ---------------------------------------------------------------------------
# Library yardsticks (timed only)
# ---------------------------------------------------------------------------


def library_fma9(x2d: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """``Σ_i x·k[i]`` per channel in one library call (``einsum``; it may
    sum the taps first, so it rounds differently from :func:`fma9`)."""
    return torch.einsum("rc,kc->rc", x2d, k9)


def library_dw(x4: torch.Tensor, w_dw: torch.Tensor) -> torch.Tensor:
    """Grouped ``F.conv2d`` on (b, H, W, C): the counterpart of
    ``xla_dw``. ``w_dw`` is (C, 1, 3, 3)."""
    y = F.conv2d(x4.permute(0, 3, 1, 2), w_dw, padding=1, groups=C)
    return y.permute(0, 2, 3, 1)


def library_sep(x4, w_dw, w_pw, sc, sh) -> torch.Tensor:
    """relu → grouped conv → 1×1 conv → affine, in x's type: the
    counterpart of ``xla_sep``. ``w_pw`` is (C, C, 1, 1)."""
    t = library_dw(torch.relu(x4), w_dw)
    y = F.conv2d(t.permute(0, 3, 1, 2), w_pw).permute(0, 2, 3, 1)
    return y * sc.reshape(C) + sh.reshape(C)


def library_weights(k9: torch.Tensor, pw: torch.Tensor):
    """(9, C) taps and (C, C) pw in the conv layouts (C, 1, 3, 3) and
    (C, C, 1, 1)."""
    return (k9.t().reshape(C, 1, 3, 3).contiguous(),
            pw.t().reshape(C, C, 1, 1).contiguous())


# ---------------------------------------------------------------------------
# Correctness + timing
# ---------------------------------------------------------------------------


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the probes time kernels on a CUDA card; got {device} with "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
    return device


def operands(device, b: int = B, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The probe's inputs as ``main()`` of the TPU script draws them, in
    bf16 on ``device``: x in both layouts, the taps, pw, sc, sh, and the
    conv-layout weights of the yardsticks."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, H, W, C)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(9, C)) * 0.2).astype(np.float32))
    pwk = torch.from_numpy((rng.normal(size=(C, C)) * 0.03).astype(
        np.float32))
    sc = torch.from_numpy(np.abs(rng.normal(size=(1, C))).astype(np.float32))
    sh = torch.from_numpy((rng.normal(size=(1, C)) * 0.01).astype(
        np.float32))
    bf = functools.partial(torch.Tensor.to, device=device,
                           dtype=torch.bfloat16)
    ops = {"x2": bf(pad_rows(x)).contiguous(), "x4": bf(x).contiguous(),
           "k9": bf(k), "pw": bf(pwk), "sc": bf(sc), "sh": bf(sh)}
    ops["w_dw"], ops["w_pw"] = library_weights(ops["k9"], ops["pw"])
    return ops


def check_correct(device="cuda") -> float:
    """dw2d against the library's grouped conv on two images' live rows:
    relative max error (the TPU script's own check, limit 0.02)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C)) * 0.2).astype(np.float32)
    x4 = torch.from_numpy(x).to(device, torch.bfloat16)
    k9 = torch.from_numpy(k.reshape(9, C)).to(device, torch.bfloat16)
    got = unpad_rows(dw2d(pad_rows(x4), k9), 2).float()
    want = library_dw(x4, library_weights(k9, k9.new_zeros(C, C))[0]).float()
    err = float((got - want).abs().max() / (want.abs().max() + 1e-6))
    print(f"dw2d vs library grouped conv: rel err {err:.4f}", flush=True)
    if not err < 0.02:
        raise RuntimeError(f"dw2d disagrees with the grouped conv: rel err "
                           f"{err}")
    return err


def make_chain_measurer(fn: Callable[[torch.Tensor], torch.Tensor],
                        x0: torch.Tensor, ks=(2, 34), repeats: int = 4):
    """Time ``fn`` by chaining it on its own output, k times inside one
    CUDA graph per k (shape-preserving fns only). Returns ``measure()``:
    the slope in seconds per application between the two k, each the
    best of ``repeats`` CUDA-event timings of one graph replay. Each
    replay adds the kernel launches its graph holds to
    :data:`launches`."""
    device = _card(x0.device)
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture's stream
            fn(fn(x0))
        torch.cuda.current_stream().wait_stream(side)
        graphs, held = {}, {}
        for k in ks:
            g = torch.cuda.CUDAGraph()
            for name in captured:
                captured[name] = 0
            with torch.cuda.graph(g):
                a = x0
                for _ in range(k):
                    a = fn(a)
            graphs[k] = g
            held[k] = {n: c for n, c in captured.items() if c}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

    def measure() -> float:
        best = {}
        with torch.cuda.device(device):
            for k in ks:
                ts = []
                for _ in range(repeats):
                    start.record()
                    graphs[k].replay()
                    end.record()
                    for name, c in held[k].items():
                        launches[name] += c
                    end.synchronize()
                    ts.append(start.elapsed_time(end) / 1e3)
                best[k] = min(ts)
        return (best[ks[1]] - best[ks[0]]) / (ks[1] - ks[0])

    return measure


def measure(name: str, fn, x0: torch.Tensor, flops_app: float,
            apps: int = 1) -> Dict[str, float]:
    """Prints and returns images/s, µs per application and TFLOP/s (the
    FLOPs of the probe's live positions, as the TPU script counts them)."""
    m = make_chain_measurer(fn, x0)
    per_iter = min(m() for _ in range(3))
    images = x0.shape[0] // P_PAD if x0.dim() == 2 else x0.shape[0]
    ips = images / per_iter
    us_app = per_iter / apps * 1e6
    out = {"img_per_s": ips, "us_per_app": us_app,
           "tflops": flops_app * ips / 1e12}
    print(f"{name:12s} {ips:10.1f} img/s  {us_app:7.1f} us/app  "
          f"{out['tflops']:6.2f} TFLOP/s", flush=True)
    return out


def main(device="cuda") -> Dict[str, Dict[str, float]]:
    device = _card(device)
    check_correct(device)
    v = operands(device)
    return {
        "fma9": measure("fma9", lambda a: fma9(a, v["k9"]), v["x2"],
                        DW_FLOPS_APP),
        "library_fma9": measure("library-fma9",
                                lambda a: library_fma9(a, v["k9"]), v["x2"],
                                DW_FLOPS_APP),
        "dw2d": measure("dw2d", lambda a: dw2d(a, v["k9"]), v["x2"],
                        DW_FLOPS_APP),
        "library_dw": measure("library-dw",
                              lambda a: library_dw(a, v["w_dw"]), v["x4"],
                              DW_FLOPS_APP),
        "sep2d_probe": measure(
            "sep2d_probe",
            lambda a: sep2d_probe(a, v["k9"], v["pw"], v["sc"], v["sh"]),
            v["x2"], DW_FLOPS_APP + PW_FLOPS_APP),
        "library_sep": measure(
            "library-sep",
            lambda a: library_sep(a, v["w_dw"], v["w_pw"], v["sc"],
                                  v["sh"]),
            v["x4"], DW_FLOPS_APP + PW_FLOPS_APP),
    }


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"total {time.time() - t0:.0f}s")
