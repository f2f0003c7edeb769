"""The port's hand-written kernels, their plain versions, their routes and
the accept-if-faster gate in front of them.

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
call that reached the card, and :data:`launches_by_body` the same by the
body that ran; both are updated under one lock, since partitions run on
a pool of threads. A kernel captured in a CUDA graph
(``ModelFunction.jitted``) launches at each replay without its wrapper:
the capture counts none and keeps, per thread, the record of the
launches its own thread's wrappers made (:func:`recording_launches`),
and each replay adds that record (:func:`add_launches`).
:data:`device_gate` gives a capture or an audition the card to itself.

**Launch plans.** :func:`plan_sep2d` and :func:`plan_pw1x1` choose, from
a call's shape and dtype alone, the body (bf16 on the Hopper tensor-core
mainloop of ``csrc/wgmma_bf16.cuh`` wherever TMA can stride the rows,
else a SIMT or ``mma.sync`` body; float32 on the SIMT mainloop of
``csrc/simt_f32.cuh``), its tile, its ring and its split of K;
:func:`plan_preproc` the band of output rows a block owns, the source
rows it stages and its shared-memory layout, with the tap tables of
:func:`preproc_tables`. The C launchers check the plan they are given
and refuse one they cannot run; the CPU tests hold the plans at every
main-path site.

**The gate.** Models never call the kernels; they call ``route_*``
(``models/layers.py``, ``ModelFunction.resized``), which returns the
kernel's result or None, and on None the caller runs its twin: the
unfused library computation (:func:`twin_sep2d`, :func:`twin_pw1x1`,
:func:`twin_preproc`) in the reference's op order.
``EngineConfig.pallas_kernels`` picks the policy, with the JAX package's
names and meanings:

- ``"autotune"`` (the default): a route runs its kernel only at a
  :class:`Site` (kernel, model family, full shape, dtype) whose verdict
  says the kernel beat its twin by at least 5% there (``kernel_s ≤
  ADOPT_SPEEDUP · twin_s``) within the numeric contract: float32 bit for
  bit, bf16 within :data:`BF16_TOLERANCE`. :func:`ensure_autotuned`, run
  by ``ModelFunction.apply_batch`` at the first sight of each input
  shape, collects the sites abstractly (a pass on meta tensors) and
  auditions each unsettled one (:func:`_audition`, CUDA-event timings).
  Verdicts are keyed by the card (name and ``sm_<major><minor>``, or
  ``cpu``) and persist in ``$SPARKDL_COMPILE_CACHE_DIR/
  sparkdl_kernel_verdicts.json`` (atomic replace, versioned).
- ``"force"``: every feasible site routes, no audition.
- ``"off"``: no site routes and nothing is auditioned.

Feasibility is the kernels' dtypes only: the TPU's VMEM budgets
(``_sep2d_geometry``, ``_pw1x1_geometry``, ``_preproc_geometry``) are not
limits of the CUDA kernels and are dropped.

One deliberate departure from the reference: its audition turns any
exception into a rejected verdict (a CPU backend has no Mosaic
lowering). Here a site on the CPU records a clean rejection (no card, so
nothing to time), but on the card a kernel that fails to build, launch
or run raises out of :func:`ensure_verdict`: no failure becomes a quiet
rejection.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import logging
import os
import threading
import time
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.core import cuda_build, telemetry

logger = logging.getLogger(__name__)

#: bf16 numeric contract (max |kernel − twin| per element a candidate may
#: show and still be adopted; also the kernel-vs-plain bound), the JAX
#: package's ``BF16_TOLERANCE``. float32 candidates must match exactly.
BF16_TOLERANCE = 0.05
#: Accept-if-faster bar: adopted only when kernel_s <= 0.95 * twin_s.
ADOPT_SPEEDUP = 0.95
#: The directory of the verdict store (the JAX package's
#: ``COMPILE_CACHE_DIR_ENV``, which also places its compile cache there).
COMPILE_CACHE_DIR_ENV = "SPARKDL_COMPILE_CACHE_DIR"
_VERDICT_STORE_BASENAME = "sparkdl_kernel_verdicts.json"
VERDICT_STORE_VERSION = 1

#: Kernel launches on the card since the last :func:`reset_launches`.
launches: Dict[str, int] = {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}
#: The same launches by the body that ran (:func:`plan_sep2d`,
#: :func:`plan_pw1x1`): ``"wgmma"`` is the Hopper tensor-core mainloop,
#: ``"simt_f32"`` the float32 mainloop of ``csrc/simt_f32.cuh``.
launches_by_body: Dict[str, Dict[str, int]] = {
    "sep2d": {"wgmma": 0, "simt_f32": 0, "simt_bf16": 0},
    "pw1x1": {"wgmma": 0, "mma": 0, "simt_f32": 0}}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "uint8": torch.uint8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _zero_counts() -> Dict[str, Any]:
    return {"launches": {name: 0 for name in launches},
            "by_body": {k: {b: 0 for b in v}
                        for k, v in launches_by_body.items()}}


# Guards every read-modify-write of the process counters: partitions run
# on a pool of threads, and each replays graphs and counts its launches.
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0
        for bodies in launches_by_body.values():
            for body in bodies:
                bodies[body] = 0


def launch_counts() -> Dict[str, Any]:
    """A copy of :data:`launches` and :data:`launches_by_body`, for
    :func:`add_launches`."""
    with _launch_lock:
        return {"launches": dict(launches),
                "by_body": {k: dict(v) for k, v in launches_by_body.items()}}


def add_launches(delta: Dict[str, Any], times: int = 1) -> None:
    """Add ``times`` × ``delta`` (a :func:`recording_launches` record) to
    the counters: a CUDA graph's replay launches
    the kernels its capture recorded without running their wrappers."""
    with _launch_lock:
        for name, n in delta["launches"].items():
            launches[name] += times * n
        for name, bodies in delta["by_body"].items():
            for body, n in bodies.items():
                launches_by_body[name][body] += times * n


def _count_launch(kernel: str, body: Optional[str] = None) -> None:
    """One launch of ``kernel`` (and of its ``body``) by a wrapper on this
    thread: into the record of the capture open on this thread, if any
    (a capture launches nothing; its graph launches the record at each
    replay), else into the process counters."""
    record = getattr(_captured, "launches", None)
    if record is not None:
        record["launches"][kernel] += 1
        if body is not None:
            record["by_body"][kernel][body] += 1
        return
    with _launch_lock:
        launches[kernel] += 1
        if body is not None:
            launches_by_body[kernel][body] += 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, Any]]:
    """While a CUDA graph is captured on this thread: the launches the
    wrappers make on this thread go to the yielded record (the graph's
    launches per replay) and not to the process counters. Launches made
    meanwhile on other threads — replays of other graphs — are counted
    as usual and never booked to this graph."""
    record = _zero_counts()
    prev = getattr(_captured, "launches", None)
    _captured.launches = record
    try:
        yield record
    finally:
        _captured.launches = prev


class _DeviceGate:
    """The process-wide lock of work that must have the card to itself:
    a graph capture (its device synchronize and cache release, then the
    capture) and a kernel audition (timings taken while other threads
    replay graphs would time the contention, not the kernel). Replays
    take it shared, so they run together and wait only while a capture
    or an audition runs. Exclusive is re-entrant for its owner (an
    audition settles inside a capture), and the owner may replay."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._owner: Optional[int] = None
        self._depth = 0
        self._readers = 0
        self._writers_waiting = 0

    @contextlib.contextmanager
    def exclusive(self) -> Iterator[None]:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += 1
            else:
                self._writers_waiting += 1
                try:
                    while self._owner is not None or self._readers:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._owner, self._depth = me, 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if self._depth == 0:
                    self._owner = None
                    self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self) -> Iterator[None]:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                owned = True
            else:
                owned = False
                while self._owner is not None or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        try:
            yield
        finally:
            if not owned:
                with self._cond:
                    self._readers -= 1
                    if not self._readers:
                        self._cond.notify_all()


#: Captures and auditions hold it exclusively, replays shared.
device_gate = _DeviceGate()


_captured = threading.local()


@contextlib.contextmanager
def holding_references() -> Iterator[List[torch.Tensor]]:
    """Collect, while a CUDA graph is captured on this thread, every
    tensor a wrapper hands its kernel by address that the capture did not
    allocate (a cached weight layout, the resize tables): the graph must
    hold them, since a replay reads them where they lay at capture."""
    held: List[torch.Tensor] = []
    prev = getattr(_captured, "held", None)
    _captured.held = held
    try:
        yield held
    finally:
        _captured.held = prev


def _hold(*tensors) -> None:
    held = getattr(_captured, "held", None)
    if held is not None:
        held.extend(t for t in tensors if t is not None)


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
# Launch plans — the body, tile and split of K for each (shape, dtype)
# ---------------------------------------------------------------------------

#: Streaming multiprocessors of the card the plans are made for (H100).
SMS = 132
#: Shared memory one block may use on Hopper, in bytes.
SMEM_LIMIT = 232448
_BODY_CODES = {"simt_bf16": 0, "mma": 1, "wgmma": 2, "simt_f32": 3}
_KCHUNK = 64          # K per stage of the tensor-core mainloop
_ROW_BYTES = 128      # one K chunk of bf16
_TILE_ALIGN = 1024
_MAX_STAGES = 4
_MAX_HALO_SLOTS = 4
#: (halo slots, stages) of the sep2d ring, in the order tried: the halo
#: loads' latency first (each refill has slots - 1 chunks to land), then
#: the depth of the ring.
_SEP2D_RINGS = ((4, 4), (4, 3), (3, 4), (3, 3), (4, 2), (3, 2), (2, 4),
                (2, 3), (2, 2))


@dataclass(frozen=True)
class Plan:
    """How one call runs: the ``body`` (``"wgmma"``, ``"mma"``,
    ``"simt_f32"`` or ``"simt_bf16"``), a block's ``bm`` rows × ``bn``
    output channels, the ``stages`` of its ring, K walked in ``chunks``
    chunks of ``chunk`` channels and cut into ``splits`` shares
    (``k_ranges``: each share's chunks, ``[begin, end)``, as the kernels
    compute them), the ``grid`` of blocks and the shared memory a block
    takes. ``note`` says why a grid stays under one wave, or why the last
    round of the float32 body is under 80% full. ``halo_slots``: the x
    halos a :func:`sep2d` block keeps in flight.

    The float32 body's persistent blocks, one on each SM, walk ``units``
    units (a row tile and ``groups`` of its N tiles, or one N tile and a
    share of K): ``waves`` is units ÷ SMs, ``fill`` the busy share of the
    SMs over the rounds (units ÷ (SMs · ⌈units ÷ SMs⌉): a busiest SM takes
    ⌈units ÷ SMs⌉).
    ``sep2d``'s ``layout`` is ``"resident"`` (a row tile's depthwise over
    all of Cin stays in shared memory while the unit sweeps its N tiles)
    or ``"streaming"`` (one chunk of it, the unit one N tile); its
    depthwise runs ``recompute`` times per (row tile, K chunk)."""

    body: str
    bm: int
    bn: int
    stages: int
    chunk: int
    chunks: int
    splits: int
    grid: Tuple[int, int, int]
    smem: int
    note: str = ""
    halo_slots: int = 0
    units: int = 0
    groups: int = 1
    waves: float = 0.0
    fill: float = 0.0
    recompute: int = 0
    layout: str = ""
    producers: int = 0

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def k_ranges(self) -> Tuple[Tuple[int, int], ...]:
        n, s = self.chunks, self.splits
        return tuple((z * n // s, (z + 1) * n // s) for z in range(s))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fit_width(cout: int, widths: Tuple[int, ...]) -> int:
    """The tile width that pads Cout least (the wider on a tie)."""
    return min(widths, key=lambda bn: (_cdiv(cout, bn) * bn, -bn))


def _split_k(tiles: int, chunks: int) -> int:
    """Shares of K that bring ``tiles`` blocks to a full wave, keeping at
    least two chunks a share."""
    if tiles >= SMS or chunks < 4:
        return 1
    return max(1, min(_cdiv(SMS, tiles), chunks // 2, 64))


def sep2d_halo(w: int) -> Tuple[int, int, int]:
    """The halo of a 64-position tile of :func:`sep2d`'s tensor-core body
    at image width ``w``: (TMA boxes, rows a box, bytes), the 64 rows and
    the ``w + 1`` before and after, boxes of at most 256 rows."""
    rows = 64 + 2 * w + 2
    boxes = _cdiv(rows, 256)
    box_rows = _cdiv(rows, boxes)
    return boxes, box_rows, boxes * box_rows * _ROW_BYTES


def _sep2d_smem(bn: int, stages: int, halo_slots: int, halo_bytes: int):
    epilogue = 2 * 64 * (bn // 2 + 8) * 2  # two warpgroups' staging rows
    return (_TILE_ALIGN + stages * (64 * _ROW_BYTES + bn * _ROW_BYTES)
            + halo_slots * halo_bytes + epilogue
            + (2 * _MAX_STAGES + _MAX_HALO_SLOTS) * 8)


@functools.lru_cache(maxsize=4096)
def plan_sep2d(b: int, h: int, w: int, cin: int, cout: int, dtype,
               aligned: bool = True) -> Plan:
    """The launch plan of :func:`sep2d`. bf16 whose rows TMA can stride
    (Cin a multiple of 8, 16-byte aligned operands) takes the tensor-core
    body: tiles of 64 positions × one output tile up to 256 channels wide
    (so a position tile's depthwise runs ceil(Cout / 256) times at most),
    the most halo slots (up to four), then the deepest ring (up to four
    stages) that fit in shared memory; ``grid`` counts the tiles, which
    persistent blocks, one per SM, walk in turn. float32 takes the SIMT
    mainloop (:func:`_plan_f32`); other bf16 the first SIMT design
    (``"simt_bf16"``: 128 × 128 tiles, K in chunks of 32, one block
    each)."""
    positions = b * h * w
    dtype = _plan_dtype(dtype)
    if dtype == torch.float32:
        return _plan_f32("sep2d", positions, cin, cout, w)
    if dtype == torch.bfloat16 and cin % 8 == 0 and aligned:
        bn = 64 if cout <= 64 else 128 if cout <= 128 else 256
        chunks = _cdiv(cin, _KCHUNK)
        halo_bytes = sep2d_halo(w)[2]
        for halo_slots, stages in _SEP2D_RINGS:
            smem = _sep2d_smem(bn, stages, halo_slots, halo_bytes)
            if smem <= SMEM_LIMIT:
                grid = (_cdiv(positions, 64), _cdiv(cout, bn), 1)
                tiles = grid[0] * grid[1]
                note = ("" if tiles >= SMS else
                        f"{positions} positions make {tiles} tiles of 64 "
                        f"x {bn}; K is not split, the depthwise would run "
                        "once per share")
                return Plan("wgmma", 64, bn, stages, _KCHUNK, chunks, 1,
                            grid, smem, note, halo_slots)
    chunks = _cdiv(cin, 32)
    grid = (_cdiv(positions, 128), _cdiv(cout, 128), 1)
    smem = ((128 + 2 * w + 2) * 32 + 2 * 32 * 132 + 128) * 4
    note = ("" if grid[0] * grid[1] >= SMS else
            f"{positions} positions make {grid[0] * grid[1]} tiles of "
            "128 x 128; the SIMT body does not split K")
    return Plan("simt_bf16", 128, 128, 1, 32, chunks, 1, grid, smem, note)


@functools.lru_cache(maxsize=4096)
def plan_pw1x1(rows: int, cin: int, cout: int, dtype,
               aligned: bool = True) -> Plan:
    """The launch plan of :func:`pw1x1`. bf16 whose rows TMA can stride
    takes the tensor-core body: 64 rows a block, the tile width of 32,
    48, 64 or 128 channels that pads Cout least, a ring of 2-4 stages.
    Other bf16 takes the ``mma.sync`` body (64 × 64), float32 the SIMT
    mainloop (:func:`_plan_f32`). The tensor-core and SIMT bodies split K
    where their tiles are under one wave."""
    dtype = _plan_dtype(dtype)
    if dtype == torch.float32:
        return _plan_f32("pw1x1", rows, cin, cout)
    if cin % 8 == 0 and aligned:
        body, bm, chunk = "wgmma", 64, _KCHUNK
        bn = _fit_width(cout, (32, 48, 64, 128))
    else:
        body, bm, bn, chunk = "mma", 64, 64, 32
    chunks = _cdiv(cin, chunk)
    tiles = _cdiv(rows, bm) * _cdiv(cout, bn)
    splits = 1 if body == "mma" else _split_k(tiles, chunks)
    stages, smem = 1, 0
    if body == "wgmma":
        stages = min(_MAX_STAGES, max(2, _cdiv(chunks, splits)))
        smem = (_TILE_ALIGN + stages * (bm + bn) * _ROW_BYTES
                + 2 * _MAX_STAGES * 8)
    note = ""
    if tiles * splits < SMS:
        note = (f"{tiles} tiles of {bm} x {bn}, and {chunks} K chunks of "
                f"{chunk} allow {splits} shares of at least two chunks")
    return Plan(body, bm, bn, stages, chunk, chunks, splits,
                (_cdiv(rows, bm), _cdiv(cout, bn), splits), smem, note)


#: The float32 mainloop (``csrc/simt_f32.cuh``): K per chunk, the most
#: stages, the most K shares (a cluster of two: at one block an SM the
#: card does not co-host 32 clusters of four), and the threads of a block:
#: 64-256 consumers, and producers in the pairs of warp slots they leave
#: (at least one pair; sep2d's depthwise makes its producers the busier).
#: One block runs on each SM.
_F32_KC = 16
_F32_MAX_STAGES = 4
_F32_MAX_SPLITS = 2
_F32_MAX_THREADS = 384
#: Lane-instructions a unit spends beside its FMAs: per staged float (a
#: copy and its addresses), per halo float (copied, read by nine taps,
#: fetched again by every unit), per depthwise row-channel (nine taps,
#: masks), per output of a pass (the epilogue).
_F32_COPY_COST = 2
_F32_HALO_COST = 8
_F32_DW_COST = 15
_F32_EPI_COST = 3


def f32_halo_boxes(bm: int, w: int) -> Tuple[int, int]:
    """``simt32::halo_boxes``: sep2d's halo of ``bm + 2w + 2`` rows as TMA
    boxes of at most 256 rows: (boxes, rows a box, even)."""
    rows = bm + 2 * w + 2
    boxes = _cdiv(rows, 256)
    return boxes, (_cdiv(rows, boxes) + 1) & ~1


def _f32_smem(sep: bool, resident: bool, bm: int, bn: int, w: int,
              stages: int, chunks: int, splits: int) -> int:
    """``simt32::smem_bytes``: room to align the base to 128 bytes, the
    ring (K-major B, then A or a streamed chunk of sep2d's D, then sep2d's
    halo boxes and its taps padded to 160 floats), sep2d's resident D, the
    split-K reduction's tile where it is larger, and the stages'
    mbarriers."""
    boxes, box_rows = f32_halo_boxes(bm, w)
    halo = boxes * box_rows * _F32_KC
    stage = (_F32_KC * bn + (0 if sep and resident else bm * (_F32_KC + 4))
             + (halo + 160 if sep else 0))
    floats = stages * stage
    if sep and resident:
        floats += bm * (chunks * _F32_KC + 4)
    if splits > 1:
        floats = max(floats, bm * (bn + 4))
    return 128 + floats * 4 + 3 * _F32_MAX_STAGES * 8


def _f32_layouts(sep: bool, rows: int, tiles: int, chunks: int):
    """(layout, groups, splits) of the float32 body to weigh: sep2d
    resident with one or two N-tile groups a row tile, or streaming (a
    unit per N tile; ``groups`` is then the N tiles); pw1x1 with K whole
    or in two shares where even 64-row tiles would leave SMs idle and
    these tiles are under one wave."""
    if sep:
        yield "resident", 1, 1
        yield "resident", 2, 1
        yield "streaming", 0, 1
        return
    for splits in range(1, _F32_MAX_SPLITS + 1):
        if splits == 1 or (rows < 64 * SMS and tiles < SMS
                           and chunks >= 2 * splits):
            yield "", 0, splits


def _f32_candidates(sep: bool, rows: int, cin: int, cout: int, w: int):
    """(cost, Plan) of every float32 tile shape, layout and split that
    fits (see :func:`_plan_f32`)."""
    chunks = _cdiv(cin, _F32_KC)
    for tx in (8, 16, 32):
        bn = 8 * tx
        tiles_n = _cdiv(cout, bn)
        for threads in range(64, 257, 32):
            if threads % tx:
                continue
            bm = 8 * (threads // tx)
            tiles_m = _cdiv(rows, bm)
            # whole pairs of warps, so that each producer keeps one column
            # of a 256-wide B row
            producers = (_F32_MAX_THREADS - threads) // 64 * 64
            for layout, groups, splits in _f32_layouts(
                    sep, rows, tiles_m * tiles_n, chunks):
                groups = groups or tiles_n
                if (groups - 1) * _cdiv(tiles_n, groups) >= tiles_n:
                    continue  # a group would be empty
                resident = layout == "resident"
                most = min(_F32_MAX_STAGES, chunks) if resident \
                    else _F32_MAX_STAGES
                for stages in range(most, 1, -1):
                    smem = _f32_smem(sep, resident, bm, bn, w, stages,
                                     chunks, splits)
                    if smem <= SMEM_LIMIT:
                        break
                else:
                    continue
                units = tiles_m * groups * splits
                if splits > 1 and units > SMS:
                    continue
                passes = _cdiv(tiles_n, groups)
                share = _cdiv(chunks, splits)
                staged = bn + (bm if not sep else 0)
                work = (passes * share * (bm * bn + _F32_COPY_COST * staged)
                        * _F32_KC + passes * bm * bn * _F32_EPI_COST)
                if sep:
                    work += chunks * _F32_KC * (
                        bm * _F32_DW_COST + _F32_HALO_COST * (bm + 2 * w + 2))
                if splits > 1:
                    work += bm * bn * (splits + 2)
                rounds = _cdiv(units, SMS)
                cost = rounds * work / min(1.0, threads / 256) ** 0.5
                yield cost, Plan(
                    "simt_f32", bm, bn, stages, _F32_KC, chunks, splits,
                    (min(units, SMS) // splits, 1, splits), smem,
                    units=units, groups=groups,
                    waves=units / SMS, fill=units / (SMS * rounds),
                    recompute=(groups if resident else
                               tiles_n if sep else 0),
                    layout=layout, producers=producers)


@functools.lru_cache(maxsize=4096)
def _plan_f32(kernel: str, rows: int, cin: int, cout: int, w: int = 0
              ) -> Plan:
    """The float32 SIMT mainloop's plan: thread tiles of 8 × 8 outputs,
    ``bm / 8`` × ``bn / 8`` consumer threads (``bn`` 64, 128 or 256;
    64-256 threads) beside the producers, K in chunks of 16, the deepest
    ring of 2-4 stages that fits (a resident D needs at least as many
    chunks as stages), persistent blocks, one on each SM (at most one a
    unit). Of the shapes that fit it takes the one whose busiest SM has
    the least work: ⌈units ÷ SMs⌉ units of FMAs plus their copies, the
    depthwise and the epilogue, slowed where the consumers are fewer than
    eight warps. ``sep2d`` keeps a row tile's depthwise resident
    (recompute 1, or 2 with two N-tile groups) unless the best streaming
    shape is over 15% cheaper; ``pw1x1`` splits K over a cluster only
    where its rows are few."""
    sep = kernel == "sep2d"
    best: Dict[Any, Tuple[Tuple[float, int, int], Plan]] = {}
    for cost, plan in _f32_candidates(sep, rows, cin, cout, w):
        kind = plan.layout if sep else plan.splits > 1
        key = (cost, plan.recompute, plan.splits)
        if kind not in best or key < best[kind][0]:
            best[kind] = (key, plan)
    if not best:
        raise ValueError(f"{kernel}: no float32 plan fits {rows} rows, "
                         f"{cin} -> {cout}")
    notes = []
    if sep:
        (stream_cost, _, _), stream = best["streaming"]
        (cost, _, _), plan = best.get("resident", ((float("inf"), 0, 0),
                                                   None))
        if plan is None or stream_cost * 1.15 < cost:
            cost, plan = stream_cost, stream
            notes.append(
                "the depthwise of every channel stays resident only in "
                f"tiles too thin to fill the card ({cin} channels), so "
                f"each N tile streams it again (recompute {plan.recompute})")
    else:
        (cost, _, _), plan = min(best.values(), key=lambda kp: kp[0])
        if plan.splits > 1:
            (whole_cost, _, _), whole = best[False]
            notes.append(
                f"{plan.units // plan.splits} tiles of {plan.bm} x {plan.bn}"
                f" are under one wave: K splits over clusters of "
                f"{plan.splits}; the best unsplit tiling ({whole.bm} x "
                f"{whole.bn}, {whole.units} tiles) would cost its busiest "
                f"SM {whole_cost / cost - 1:.0%} more")
    if plan.blocks < SMS and plan.splits == 1:
        notes.append(f"{plan.units} units of {plan.bm} x {plan.bn} are "
                     "fewer than the SMs: each takes one")
    if plan.fill < 0.8:
        notes.append(
            f"no tile shape fills the last round: {plan.units} units over "
            f"{SMS} SMs leave {plan.fill:.0%} of the rounds busy")
    return dataclasses.replace(plan, note="; ".join(notes))


def _plan_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _weight_nk(pw: torch.Tensor) -> torch.Tensor:
    """The (Cout, Cin) contiguous layout the bf16 bodies read, from a
    logical (Cin, Cout) weight: free when ``pw`` is the transpose of such a
    tensor (as the routes pass it), one copy otherwise."""
    w = pw.t()
    return w if w.is_contiguous() else w.contiguous()


#: id(weight) -> (a weak reference to it, its version, data pointer and
#: device, its (Cin, Cout) copy): the float32 body's weight layout, made
#: once per conv weight; an entry goes with its weight.
_kn_weights: Dict[int, Tuple[Any, ...]] = {}


def _kn_weight(weight: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The (Cin, Cout) contiguous float32 layout of a (Cout, Cin, ...)
    conv weight, for the float32 body: made at the first call and again
    after the weight changes (in place, or moved)."""
    if weight.is_inference():  # no version to tell a change by
        return weight.reshape(cout, cin).t().contiguous()
    stamp = (weight._version, weight.data_ptr(), weight.device)
    key = id(weight)
    hit = _kn_weights.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == stamp:
        _hold(hit[2])
        return hit[2]
    kn = weight.reshape(cout, cin).t().contiguous()
    ref = weakref.ref(weight, lambda _, key=key: _kn_weights.pop(key, None))
    _kn_weights[key] = (ref, stamp, kn)
    _hold(kn)
    return kn


def _weight_layout(pw: torch.Tensor, x: torch.Tensor,
                   name: str) -> torch.Tensor:
    """The layout the body of x's dtype reads, from a logical (Cin, Cout)
    weight, checked against x: (Cout, Cin) for bf16 (:func:`_weight_nk`),
    (Cin, Cout) contiguous for float32 (its mainloop reads B K-major; one
    transposing copy when ``pw`` is a transposed view)."""
    cin, cout = x.shape[-1], pw.shape[-1]
    if x.dtype == torch.float32:
        w = pw if pw.is_contiguous() else pw.contiguous()
        _check(w, f"{name} (as Cin x Cout)", x.device, x.dtype, (cin, cout))
        return w
    w = _weight_nk(pw)
    _check(w, f"{name} (as Cout x Cin)", x.device, x.dtype, (cout, cin))
    return w


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
    affine, float32, (Cout,) or (1, Cout). The bf16 bodies read ``pw`` as
    (Cout, Cin) (pass the transpose of a contiguous (Cout, Cin) tensor to
    spare the copy), the float32 body as (Cin, Cout) (a contiguous ``pw``
    is read as it lies). :func:`plan_sep2d` picks the body."""
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
    w_lay = _weight_layout(pw, x, "pw")
    scale, shift = scale.reshape(cout), shift.reshape(cout)
    _check(scale, "scale", x.device, torch.float32, (cout,))
    _check(shift, "shift", x.device, torch.float32, (cout,))
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = plan_sep2d(b, h, w, cin, cout, x.dtype,
                      aligned=_aligned(x, dw9, w_lay))
    fn = _sep2d_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dw9.data_ptr(), w_lay.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                 b, h, w, cin, cout, int(relu_in), _DTYPE_CODES[x.dtype],
                 _BODY_CODES[plan.body], plan.bn, plan.stages,
                 plan.halo_slots, plan.bm, plan.groups,
                 int(plan.layout == "resident"), plan.producers,
                 plan.grid[0], stream)
    _raise_on_error(err, "sep2d")
    _count_launch("sep2d", plan.body)
    return out


@functools.lru_cache(maxsize=None)
def _sep2d_fn():
    fn = cuda_build.library("sep2d").sparkdl_sep2d
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 \
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
    BN affine, float32, (Cout,) or (1, Cout). The bf16 bodies read ``w2``
    as (Cout, Cin) (pass the transpose of a contiguous (Cout, Cin) tensor
    to spare the copy), the float32 body as (Cin, Cout) (a contiguous
    ``w2`` is read as it lies). :func:`plan_pw1x1` picks the body and the
    split of K;
    the tensor-core body's split K sums its shares in a float32 workspace
    and a second launch reduces them (both count as this call's one
    launch); the float32 body's shares meet in a cluster's shared memory
    (one launch)."""
    if not _on_card(x, "pw1x1"):
        return plain_pw1x1(x, w2, scale, shift, relu=relu)
    if x.dim() != 4:
        raise ValueError(f"pw1x1: x must be (B, H, W, Cin), got {x.shape}")
    b, h, w, cin = x.shape
    cout = w2.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pw1x1: x must be float32 or bfloat16, got {x.dtype}")
    _check(x, "x", x.device, x.dtype, (b, h, w, cin))
    w_lay = _weight_layout(w2, x, "w2")
    scale, shift = scale.reshape(cout), shift.reshape(cout)
    _check(scale, "scale", x.device, torch.float32, (cout,))
    _check(shift, "shift", x.device, torch.float32, (cout,))
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows = b * h * w
    plan = plan_pw1x1(rows, cin, cout, x.dtype, aligned=_aligned(x, w_lay))
    ws = (torch.empty((plan.splits, rows, cout), dtype=torch.float32,
                      device=x.device)
          if plan.splits > 1 and plan.body == "wgmma" else None)
    fn = _pw1x1_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_lay.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None, rows, cin, cout,
                 int(relu), _DTYPE_CODES[x.dtype], _BODY_CODES[plan.body],
                 plan.bn, plan.stages, plan.splits, plan.bm, plan.producers,
                 plan.grid[0], stream)
    _raise_on_error(err, "pw1x1")
    _count_launch("pw1x1", plan.body)
    return out


@functools.lru_cache(maxsize=None)
def _pw1x1_fn():
    fn = cuda_build.library("pw1x1").sparkdl_pw1x1
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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


#: The band heights a :func:`preproc_resize` plan tries, tallest first.
_PREPROC_BAND_ROWS = (16, 8, 4, 2, 1)
#: Shared memory a block takes at most where it can, so that four blocks
#: share an SM (228 KB an SM, less 1 KB a block), and the blocks a plan
#: wants at least: one block's staging then overlaps another's stores.
_PREPROC_SMEM_TARGET = 57 * 1024
_PREPROC_MIN_BLOCKS = 2 * SMS
#: The block's mbarrier, then one 16-byte record per band row.
_PREPROC_INFO_OFF = 16


@dataclass(frozen=True)
class PreprocPlan:
    """How one :func:`preproc_resize` call runs. A block of 256 threads
    owns a band of ``band_rows`` output rows of one image
    (``grid`` = (bands, images, 1); the last band may be shorter).
    ``staged``: the block stages the source rows its band taps in shared
    memory, as ``runs[k]``, band k's runs of consecutive source rows,
    each (first row, rows, byte offset in the staging area), the area
    ``staged_bytes`` at most (a run's slot rounded up to 16 bytes, plus
    16 for its address modulo 16), at most ``run_stride`` runs a band;
    otherwise the vertical pass reads the image in device memory and
    ``runs`` is empty. ``dense``: every source
    column is tapped (else a table compacts the tapped ones); ``nxc``
    floats make one row of the vertical pass, (tapped columns) × C.
    ``src_off``, ``t_off`` and ``out_off`` place the staging area, the
    vertical pass's rows and the band's output image in the block's
    ``smem`` bytes. ``note`` says why a plan stays under its targets."""

    th: int
    band_rows: int
    runs: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    run_stride: int
    staged: bool
    dense: bool
    nxc: int
    staged_bytes: int
    src_off: int
    t_off: int
    out_off: int
    smem: int
    grid: Tuple[int, int, int]
    note: str = ""

    @property
    def bands(self) -> int:
        return self.grid[0]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def band(self, k: int) -> Tuple[int, int]:
        """Band k's output rows, ``[begin, end)``."""
        return k * self.band_rows, min((k + 1) * self.band_rows, self.th)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _band_runs(taps: np.ndarray, row_bytes: int
               ) -> Tuple[Tuple[int, int, int], ...]:
    """The runs that stage the source rows ``taps`` (a band's (rows, 2)
    row taps) name: consecutive rows, a gap of one row bridged (a copy
    of one more row is cheaper than another run), each with its byte
    offset in the staging area."""
    spans = []
    for row in sorted(set(int(r) for r in taps.ravel())):
        if spans and row <= spans[-1][1] + 1:
            spans[-1][1] = row
        else:
            spans.append([row, row])
    runs, offset = [], 0
    for first, last in spans:
        runs.append((first, last - first + 1, offset))
        offset += _align16((last - first + 1) * row_bytes) + 16
    return tuple(runs)


def _preproc_layout(band_rows: int, staged_bytes: int, nxc: int, twc: int,
                    out_item: int) -> Tuple[int, int, int, int]:
    """(src_off, t_off, out_off, smem) of a block: the mbarrier and the
    band-row records, the staging area, the vertical pass's float32
    rows, then the band's output image and 16 bytes for its shift."""
    src_off = _align16(_PREPROC_INFO_OFF + 16 * band_rows)
    t_off = src_off + staged_bytes
    out_off = t_off + _align16(4 * band_rows * nxc)
    return src_off, t_off, out_off, out_off + _align16(
        band_rows * twc * out_item) + 16


@functools.lru_cache(maxsize=256)
def plan_preproc(b: int, h: int, w: int, c: int, th: int, tw: int,
                 in_dtype, out_dtype,
                 band_rows: Optional[int] = None) -> PreprocPlan:
    """The launch plan of :func:`preproc_resize` for ``b`` images of
    ``h × w × c`` to ``th × tw``: the tallest band (16, 8, 4, 2 or 1
    output rows) whose block fits four to an SM while the grid keeps two
    blocks an SM, else the shortest that fits at all; its source rows
    staged in shared memory where one band's fit (a steep downscale
    stages two rows an output row), else read from device memory.
    ``band_rows`` pins the band height. Raises ValueError for a call one
    block cannot hold: an output row's float32 pass and output image
    over the shared memory, over 65,535 images, or an image of 2³¹
    elements."""
    if min(b, h, w, c, th, tw) <= 0:
        raise ValueError(f"preproc_resize: empty shape {(b, h, w, c)} -> "
                         f"{(th, tw)}")
    if b > 65535 or h * w * c >= 2 ** 31 or th * tw * c >= 2 ** 31:
        raise ValueError(f"preproc_resize: {b} images of {h}x{w}x{c} -> "
                         f"{th}x{tw} exceed the launch's 32-bit indices")
    item, out_item = in_dtype.itemsize, out_dtype.itemsize
    ytaps = _resize_taps(h, th)[0]
    columns = len(np.unique(_resize_taps(w, tw)[0]))
    nxc, twc, row_bytes = columns * c, tw * c, w * c * item
    heights = _PREPROC_BAND_ROWS if band_rows is None else (band_rows,)
    for staged in (True, False):
        fits = []
        for r in heights:
            runs = tuple(_band_runs(ytaps[k * r:(k + 1) * r], row_bytes)
                         for k in range(_cdiv(th, r))) if staged else ()
            staged_bytes = max((o + _align16(n * row_bytes) + 16
                                for band in runs for _, n, o in band[-1:]),
                               default=0)
            layout = _preproc_layout(r, staged_bytes, nxc, twc, out_item)
            if layout[3] <= SMEM_LIMIT:
                fits.append((r, runs, staged_bytes, layout))
        if not fits:
            continue
        pick = next((f for f in fits if f[3][3] <= _PREPROC_SMEM_TARGET
                     and _cdiv(th, f[0]) * b >= _PREPROC_MIN_BLOCKS),
                    fits[-1])
        r, runs, staged_bytes, layout = pick
        blocks = _cdiv(th, r) * b
        notes = [] if staged else ["one output row's source rows do not "
                                   "fit: the vertical pass reads device "
                                   "memory"]
        if blocks < _PREPROC_MIN_BLOCKS:
            notes.append(f"{th} output rows of {b} images make {blocks} "
                         f"blocks at bands of {r}")
        elif layout[3] > _PREPROC_SMEM_TARGET:
            notes.append(f"a band of {r} takes {layout[3]} bytes: under "
                         "four blocks an SM")
        return PreprocPlan(th, r, runs, max(map(len, runs), default=0),
                           staged, columns == w, nxc, staged_bytes, *layout,
                           (_cdiv(th, r), b, 1), note="; ".join(notes))
    raise ValueError(
        f"preproc_resize: one output row of {tw}x{c} ({out_dtype}) and its "
        f"float32 pass over {nxc} source values exceed {SMEM_LIMIT} bytes "
        "of shared memory")


@functools.lru_cache(maxsize=64)
def preproc_tables(plan: PreprocPlan, h: int, w: int, c: int, tw: int
                   ) -> Dict[str, Optional[np.ndarray]]:
    """The tables a :func:`preproc_resize` launch reads, int32 (weights
    as their float32 bits):

    - ``runs`` (bands · run_stride, 4), when staged: each band's runs
      (first source row, rows, byte offset, 0), the band's count in its
      first run's last field;
    - ``rowtab`` (th, 4): each output row's two row taps and, when
      staged, the runs (of its band) that hold them; ``ywt`` (th, 2)
      float32, their weights;
    - ``vsrc`` (nxc,): the source (column, channel) of each value of a
      vertical-pass row, None when dense;
    - ``htab`` (tw·c, 4): each output (column, channel)'s two indices into
      that row and its two column weights."""
    ytaps, ywt = _resize_taps(h, plan.th)
    xtaps, xwt = _resize_taps(w, tw)
    columns = np.unique(xtaps)
    slot = np.zeros(w, np.int64)
    slot[columns] = np.arange(len(columns))
    ch = np.arange(c)
    htab = np.stack([(slot[xtaps[:, 0]][:, None] * c + ch).ravel(),
                     (slot[xtaps[:, 1]][:, None] * c + ch).ravel(),
                     np.repeat(xwt[:, 0], c).view(np.int32),
                     np.repeat(xwt[:, 1], c).view(np.int32)],
                    axis=1).astype(np.int32)
    rowtab = np.zeros((plan.th, 4), np.int32)
    rowtab[:, :2] = ytaps
    runs = np.zeros((len(plan.runs), max(plan.run_stride, 1), 4), np.int32)
    for k, band in enumerate(plan.runs):
        begin, end = plan.band(k)
        for tap in (0, 1):
            rows = ytaps[begin:end, tap]
            for i, (first, n, _) in enumerate(band):
                rowtab[begin:end, 2 + tap][(rows >= first)
                                           & (rows < first + n)] = i
        runs[k, :len(band), :3] = band
        runs[k, 0, 3] = len(band)
    return {"runs": runs.reshape(-1, 4) if plan.staged else None,
            "rowtab": rowtab, "ywt": np.ascontiguousarray(ywt),
            "vsrc": None if plan.dense else
            (columns[:, None] * c + ch).ravel().astype(np.int32),
            "htab": htab}


@functools.lru_cache(maxsize=64)
def _device_preproc_tables(plan: PreprocPlan, h: int, w: int, c: int,
                           tw: int, device: str):
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in preproc_tables(plan, h, w, c, tw).items()}


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
    bfloat16 → ``(B, th, tw, C)`` in ``out_dtype`` (float32/bfloat16), one
    launch planned by :func:`plan_preproc`."""
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
    out = torch.empty((b, th, tw, c), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch_preproc(_preproc_fn(), x, out,
                   plan_preproc(b, h, w, c, th, tw, x.dtype, out_dtype))
    _count_launch("preproc_resize")
    return out


def launch_preproc(fn, x: torch.Tensor, out: torch.Tensor,
                   plan: PreprocPlan) -> None:
    """One launch of ``fn`` (``sparkdl_preproc_resize`` of a library built
    from ``csrc/preproc_resize.cu``) under ``plan``; raises if the
    launch is refused."""
    b, h, w, c = x.shape
    th, tw = out.shape[1:3]
    tabs = _device_preproc_tables(plan, h, w, c, tw, str(x.device))
    _hold(*tabs.values())

    def ptr(name):
        t = tabs[name]
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), ptr("runs"), ptr("rowtab"),
                 ptr("ywt"), ptr("vsrc"), ptr("htab"), b, h, w * c, th,
                 tw * c, plan.band_rows, plan.nxc, plan.run_stride,
                 plan.src_off, plan.t_off, plan.out_off,
                 plan.smem, int(plan.staged), _DTYPE_CODES[x.dtype],
                 _DTYPE_CODES[out.dtype], stream)
    _raise_on_error(err, "preproc_resize")


#: ``sparkdl_preproc_resize``'s parameters: seven pointers, fifteen
#: ints, the stream.
_PREPROC_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                     + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _preproc_fn():
    fn = cuda_build.library("preproc_resize").sparkdl_preproc_resize
    fn.argtypes = _PREPROC_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Twins — the unfused library computations, in the reference's op order
# ---------------------------------------------------------------------------


def _bn_reference(y, gamma, beta, mean, var, eps):
    """Inference BN in the reference's order, ``(y − mean)·(γ·rsqrt(var +
    eps)) + β``, NOT the folded affine: a float32 candidate's exactness
    is judged against this."""
    mul = torch.rsqrt(var + eps)
    if gamma is not None:
        mul = mul * gamma
    return (y - mean) * mul + beta


def twin_sep2d(x, dw_weight, pw_weight, gamma, beta, mean, var, eps,
               relu_in: bool = False):
    """Twin of :func:`sep2d`: relu? → grouped conv → 1×1 conv → BN, on
    NHWC ``x`` with weights (Cin, 1, 3, 3) and (Cout, Cin, 1, 1)."""
    if relu_in:
        x = torch.relu(x)
    t = F.conv2d(x.permute(0, 3, 1, 2), dw_weight, padding=1,
                 groups=x.shape[-1])
    y = F.conv2d(t, pw_weight).permute(0, 2, 3, 1)
    return _bn_reference(y, gamma, beta, mean, var, eps)


def twin_pw1x1(x, conv_weight, gamma, beta, mean, var, eps,
               relu: bool = False):
    """Twin of :func:`pw1x1`: 1×1 conv → BN → relu?, weight
    (Cout, Cin, 1, 1)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv_weight).permute(0, 2, 3, 1)
    y = _bn_reference(y, gamma, beta, mean, var, eps)
    return torch.relu(y) if relu else y


def twin_preproc(x, target_hw: Tuple[int, int], out_dtype):
    """Twin of :func:`preproc_resize`: cast to ``out_dtype``, then
    ``F.interpolate`` bilinear (half-pixel centres, no antialias)."""
    y = F.interpolate(x.to(out_dtype).permute(0, 3, 1, 2),
                      size=(int(target_hw[0]), int(target_hw[1])),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Sites and verdicts
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Site:
    """One kernel site: which kernel would run, for which model family, at
    which full launch shape (batch included, so each bucket rung is its
    own site) and dtype."""

    kernel: str
    family: str
    shape: Tuple[int, ...]
    dtype: str


def _backend_tag(device) -> str:
    """``cpu``, or the card's name and ``sm_<major><minor>``: verdicts
    taken on one card never answer for another."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def _site_key(site: Site, device) -> str:
    return "|".join((site.kernel, site.family,
                     "x".join(str(d) for d in site.shape), site.dtype,
                     _backend_tag(device)))


def verdict_store_path() -> Optional[str]:
    """``$SPARKDL_COMPILE_CACHE_DIR/sparkdl_kernel_verdicts.json``; None
    when the variable is unset (verdicts then stay in the process)."""
    cache_dir = os.environ.get(COMPILE_CACHE_DIR_ENV)
    if not cache_dir:
        return None
    return os.path.join(cache_dir, _VERDICT_STORE_BASENAME)


_verdicts: Dict[str, Dict[str, Any]] = {}
_verdicts_loaded = False
_verdict_lock = threading.Lock()
# per-site single flight: a second caller of the same site waits on the
# owner's event (no lock is held across an audition's device work)
_inflight: Dict[str, threading.Event] = {}


def _read_store() -> Dict[str, Dict[str, Any]]:
    """The store file's verdicts. A corrupt file, another ``version`` or
    a malformed entry is discarded, never trusted: the worst case is an
    audition run again."""
    path = verdict_store_path()
    if path is None:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) \
            or doc.get("version") != VERDICT_STORE_VERSION:
        return {}
    stored = doc.get("verdicts")
    if not isinstance(stored, dict):
        return {}
    return {key: verdict for key, verdict in stored.items()
            if isinstance(key, str) and isinstance(verdict, dict)
            and isinstance(verdict.get("adopted"), bool)}


def _ensure_loaded() -> None:
    """Fill the in-memory map from the store file once per process (or
    after :func:`reset`)."""
    global _verdicts_loaded
    if _verdicts_loaded:
        return
    stored = _read_store()
    with _verdict_lock:
        if _verdicts_loaded:
            return
        for key, verdict in stored.items():
            _verdicts.setdefault(key, verdict)
        _verdicts_loaded = True


def _persist_verdict(key: str, verdict: Dict[str, Any]) -> None:
    """Merge one verdict into the store file (tmp file + ``os.replace``;
    concurrent writers race whole files and the last wins: the store is a
    cache, not a source of truth)."""
    path = verdict_store_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc: Dict[str, Any] = {"version": VERDICT_STORE_VERSION,
                               "verdicts": {}}
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) \
                    and loaded.get("version") == VERDICT_STORE_VERSION \
                    and isinstance(loaded.get("verdicts"), dict):
                doc = loaded
        except (OSError, ValueError):
            pass
        doc["verdicts"][key] = verdict
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError as e:  # persistence is best effort
        logger.warning("could not persist kernel verdict to %s: %s", path,
                       e)


def verdict_for(site: Site, device) -> Optional[Dict[str, Any]]:
    """The settled verdict of ``site`` on ``device``'s backend (None:
    never auditioned there)."""
    _ensure_loaded()
    key = _site_key(site, device)
    with _verdict_lock:
        return _verdicts.get(key)


def verdicts_snapshot() -> Dict[str, Dict[str, Any]]:
    """Every verdict this process knows, by site key."""
    _ensure_loaded()
    with _verdict_lock:
        return {k: dict(v) for k, v in _verdicts.items()}


_generation = 0


def generation() -> int:
    """Bumped by each :func:`reset`: a program captured under one
    generation's verdicts (``ModelFunction.jitted``) never replays under
    another's."""
    return _generation


def reset() -> None:
    """Forget every in-memory verdict; the store file, if any, is read
    again at the next lookup."""
    global _verdicts_loaded, _generation
    with _verdict_lock:
        _verdicts.clear()
        _verdicts_loaded = False
        _generation += 1


# ---------------------------------------------------------------------------
# Modes, collection and routing decisions
# ---------------------------------------------------------------------------


def kernel_mode() -> str:
    """``EngineConfig.pallas_kernels``, read at each decision."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    return EngineConfig.pallas_kernels


_collect = threading.local()


def _collecting() -> Optional[Counter]:
    return getattr(_collect, "sites", None)


def _decide(site: Site, feasible: bool, device) -> bool:
    """True: the route runs its kernel. Under a collection scope
    (:func:`collect_sites`) a feasible site is counted and the twin
    chosen, so collecting launches no kernel. ``"force"`` routes every
    feasible site; ``"autotune"`` needs an adopted verdict."""
    sites = _collecting()
    if sites is not None:
        if feasible:
            sites[site] += 1
        return False
    mode = kernel_mode()
    if mode == "force":
        return feasible
    if mode != "autotune" or not feasible:
        return False
    verdict = verdict_for(site, device)
    return bool(verdict is not None and verdict.get("adopted"))


class _Calls(torch.nn.Module):
    """``fn(x)`` with ``variables`` as a submodule, so that
    ``torch.func.functional_call`` can swap its parameters and buffers."""

    def __init__(self, fn: Callable, variables: torch.nn.Module) -> None:
        super().__init__()
        self.variables = variables
        # not a submodule even when fn is a Module: only ``variables`` is
        # swapped, once, and restored
        self.__dict__["_fn"] = fn

    def forward(self, x):
        return self._fn(x)


#: Held while a model's weights are moved (``ModelFunction.to``), swapped
#: for meta tensors (:func:`collect_sites`, :func:`abstract_output`) or
#: read by an eager forward (a warm-up, a capture, a forward on the CPU):
#: partition threads share one model, and a forward on one thread must
#: never see another thread's meta swap. Re-entrant; taken after
#: :data:`device_gate` where both are held.
weights_lock = threading.RLock()


def _run_on_meta(fn: Callable, x: torch.Tensor, variables):
    meta_x = torch.empty_like(x, device="meta")
    if not isinstance(variables, torch.nn.Module):
        return fn(meta_x)
    with weights_lock:
        named = list(variables.named_parameters()) \
            + list(variables.named_buffers())
        meta = {f"variables.{name}": t.to("meta") for name, t in named}
        return torch.func.functional_call(_Calls(fn, variables), meta,
                                          (meta_x,))


def _abstract_pass(fn: Callable, x: torch.Tensor, variables
                   ) -> Tuple[Counter, Any]:
    sites: Counter = Counter()
    prev = _collecting()
    _collect.sites = sites
    try:
        out = _run_on_meta(fn, x, variables)
    finally:
        _collect.sites = prev
    return sites, out


def collect_sites(fn: Callable, x: torch.Tensor,
                  variables=None) -> Counter:
    """The feasible sites ``fn(x)`` routes through, each with the number
    of its calls in one forward. ``fn`` runs on meta tensors: ``x``'s
    shape and dtype, and ``variables`` (the ``nn.Module`` that ``fn``
    runs, if any) with its parameters and buffers swapped for meta
    tensors meanwhile, under :data:`weights_lock`. Every route returns None before it touches a
    tensor: no kernel launches. An operation with no meta version makes
    the pass raise."""
    return _abstract_pass(fn, x, variables)[0]


def abstract_output(fn: Callable, x: torch.Tensor, variables=None):
    """``fn(x)``'s output as meta tensors (its shape and dtype), from the
    same pass as :func:`collect_sites`: nothing is computed and no kernel
    launches (the JAX package's ``jax.eval_shape``)."""
    return _abstract_pass(fn, x, variables)[1]


def ensure_autotuned(fn: Callable, x: torch.Tensor, model: str = "model",
                     variables=None) -> Counter:
    """Settle the verdict of every site ``fn(x)`` routes through, before
    its first real run (``ModelFunction.apply_batch`` calls this at the
    first sight of each input shape): :func:`collect_sites`, then
    :func:`ensure_verdict` for each site on ``x``'s device. Returns the
    sites with their calls per forward; a no-op outside ``"autotune"``."""
    if kernel_mode() != "autotune":
        return Counter()
    sites = collect_sites(fn, x, variables)
    logger.debug("kernel sites of %s at %s: %d", model, tuple(x.shape),
                 len(sites))
    for site in sorted(sites):
        ensure_verdict(site, x.device)
    return sites


# ---------------------------------------------------------------------------
# The audition (accept-if-faster within the numeric contract)
# ---------------------------------------------------------------------------


def _backend_supported(device) -> bool:
    return torch.device(device).type == "cuda"


_AUDITION_EPS = 1e-3  # keras BN default; verdict-neutral (not keyed)


def _build_shootout(site: Site, device):
    """(kernel_fn, twin_fn, x) at the site's exact shape on ``device``,
    with the JAX package's synthetic O(1) operands (``default_rng(0)``,
    drawn in its order and layouts), so the bf16 bound means something."""
    rng = np.random.default_rng(0)

    def draw(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device)

    if site.kernel == "preproc":
        b, h, w, c, th, tw = site.shape
        in_dt, out_dt = (_DTYPES[n] for n in site.dtype.split("->"))
        if in_dt == torch.uint8:
            x = torch.from_numpy(rng.integers(0, 256, size=(b, h, w, c))
                                 .astype(np.uint8)).to(device)
        else:
            x = draw(rng.normal(size=(b, h, w, c))).to(in_dt)
        return (lambda a: preproc_resize(a, (th, tw), out_dt),
                lambda a: twin_preproc(a, (th, tw), out_dt), x)
    b, h, w, cin, cout = site.shape
    dt = _DTYPES[site.dtype]
    x = draw(rng.normal(size=(b, h, w, cin))).to(dt)
    gamma = draw(np.abs(rng.normal(size=cout)) + 0.5)
    beta = draw(rng.normal(size=cout) * 0.1)
    mean = draw(rng.normal(size=cout) * 0.1)
    var = draw(np.abs(rng.normal(size=cout)) + 1.0)
    bn = [t.to(dt) for t in (gamma, beta, mean, var)]
    scale, shift = _fold_bn(gamma, beta, mean, var, _AUDITION_EPS)
    if site.kernel == "sep2d":
        dw = rng.normal(size=(3, 3, 1, cin)) * 0.2            # HWIO
        pw = rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin)
        w_dw = draw(dw.transpose(3, 2, 0, 1)).to(dt)         # (Cin,1,3,3)
        w_pw = draw(pw.transpose(3, 2, 0, 1)).to(dt)         # (Cout,Cin,1,1)
        dw9 = w_dw.reshape(cin, 9).t().contiguous()
        pw2 = _route_weight(w_pw, cout, cin, dt)  # as the routes pass it
        return (lambda a: sep2d(a, dw9, pw2, scale, shift),
                lambda a: twin_sep2d(a, w_dw, w_pw, *bn, _AUDITION_EPS), x)
    relu = site.kernel == "pw1x1_relu"
    w4 = draw((rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin))
              .transpose(3, 2, 0, 1)).to(dt)
    w2 = _route_weight(w4, cout, cin, dt)  # as the routes pass it
    return (lambda a: pw1x1(a, w2, scale, shift, relu=relu),
            lambda a: twin_pw1x1(a, w4, *bn, _AUDITION_EPS, relu=relu), x)


def _time_calls(fn: Callable, x: torch.Tensor, repeats: int = 5,
                inner: int = 3) -> float:
    """Seconds per call: the best of ``repeats`` means of ``inner``
    back-to-back calls, from CUDA events on x's device."""
    best = float("inf")
    with torch.cuda.device(x.device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            for _ in range(inner):
                fn(x)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / inner)
    return best


def _audition(site: Site, device) -> Dict[str, Any]:
    """One shootout: both candidates at the site's shape, the numeric
    contract, both timed, the decision. On the CPU it records a clean
    rejection; on the card a kernel that cannot build, launch or run
    raises. On the card it holds :data:`device_gate` exclusively, so no
    other thread's replay runs inside its timings."""
    t0 = time.perf_counter()
    verdict: Dict[str, Any] = {"adopted": False,
                               "backend": _backend_tag(device)}
    if not _backend_supported(device):
        verdict["reason"] = (f"no CUDA device ({device}): the kernel runs "
                             "only on the card, so there is nothing to time")
    else:
        with device_gate.exclusive(), torch.inference_mode():
            kernel_fn, twin_fn, x = _build_shootout(site, device)
            y_twin = twin_fn(x)
            y_kernel = kernel_fn(x)
            if y_kernel.shape != y_twin.shape:
                raise RuntimeError(f"{site}: kernel shape {y_kernel.shape} "
                                   f"!= twin shape {y_twin.shape}")
            a, b = y_kernel.float().cpu(), y_twin.float().cpu()
            err = float((a - b).abs().max()) if a.numel() else 0.0
            if y_twin.dtype == torch.float32:
                numeric_ok = torch.equal(a, b)
                contract = "fp32-exact"
            else:
                numeric_ok = err <= BF16_TOLERANCE
                contract = f"max-abs<={BF16_TOLERANCE}"
            twin_s = _time_calls(twin_fn, x)
            kernel_s = _time_calls(kernel_fn, x)
        verdict.update(max_abs_err=err, twin_s=twin_s, kernel_s=kernel_s)
        if not numeric_ok:
            verdict["reason"] = (f"numeric contract violated ({contract}, "
                                 f"err={err:.3g})")
        elif kernel_s > ADOPT_SPEEDUP * twin_s:
            verdict["reason"] = (f"not faster (kernel {kernel_s * 1e6:.0f}us"
                                 f" vs twin {twin_s * 1e6:.0f}us, needs <= "
                                 f"{ADOPT_SPEEDUP:.2f}x)")
        else:
            verdict["adopted"] = True
            verdict["reason"] = (f"{twin_s / max(kernel_s, 1e-12):.2f}x "
                                 "speedup, numerics in contract")
    verdict["audition_s"] = time.perf_counter() - t0
    if telemetry.active() is not None:
        telemetry.observe(telemetry.M_KERNEL_AUTOTUNE_S,
                          verdict["audition_s"])
        telemetry.count(telemetry.M_KERNEL_ADOPTED if verdict["adopted"]
                        else telemetry.M_KERNEL_REJECTED)
    logger.info("kernel audition %s: %s — %s", _site_key(site, device),
                "ADOPTED" if verdict["adopted"] else "rejected",
                verdict["reason"])
    return verdict


def ensure_verdict(site: Site, device) -> Dict[str, Any]:
    """The settled verdict of ``site`` on ``device``, auditioning it once
    if it never was there. Single flight per site: a concurrent caller
    of the same site waits for the owner's verdict; if the owner's
    audition raises, the exception reaches the owner's caller and a
    waiter tries again itself."""
    key = _site_key(site, device)
    while True:
        found = verdict_for(site, device)
        if found is not None:
            return found
        with _verdict_lock:
            event = _inflight.get(key)
            owner = event is None
            if owner:
                event = threading.Event()
                _inflight[key] = event
        if not owner:
            event.wait()
            continue  # the owner settled (or failed): read again
        try:
            verdict = _audition(site, device)
            with _verdict_lock:
                _verdicts[key] = verdict
            _persist_verdict(key, verdict)
            return verdict
        finally:
            with _verdict_lock:
                _inflight.pop(key, None)
            event.set()


# ---------------------------------------------------------------------------
# Routes — the only entry points models use
# ---------------------------------------------------------------------------


def _route_weight(weight, cout: int, cin: int, dtype) -> torch.Tensor:
    """A conv weight (Cout, Cin, ...) as the (Cin, Cout) logical weight of
    the kernels, in the layout the body of ``dtype`` reads without a copy:
    bf16 the transpose of the conv's own (Cout, Cin), float32 a contiguous
    (Cin, Cout) made once per weight (:func:`_kn_weight`)."""
    if dtype == torch.float32 and weight.dtype == torch.float32:
        return _kn_weight(weight, cout, cin)
    return weight.reshape(cout, cin).to(dtype).contiguous().t()


def _refuse_recording(site: Site, *tensors) -> None:
    """A kernel has no backward, as the reference's ``pallas_call`` has
    none (``jax.grad`` through it raises): a route that would launch one
    while autograd records a gradient through its operands raises rather
    than return an output cut off from the graph. It raises on the CPU
    too, where the plain version would differentiate without complaint,
    and never falls back to that version quietly."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise ValueError(
            f"kernel site {site.kernel} ({site.family}, shape {site.shape}, "
            f"{site.dtype}) would run a kernel with no backward while "
            "autograd records a gradient through its operands; run the "
            "forward under torch.no_grad() or torch.inference_mode(), or "
            "set EngineConfig.pallas_kernels = 'off' to train through "
            "the plain layers")


def route_sep2d(x, dw_weight, pw_weight, bn_weight, bn_bias, bn_mean,
                bn_var, eps: float, *, family: str):
    """The fused sepconv body for one site, or None (the caller runs its
    twin). Weights are in the port's layout: depthwise (Cin, 1, 3, 3),
    pointwise (Cout, Cin, 1, 1); they are cast to x's type as the JAX
    route does."""
    b, h, w, cin = x.shape
    cout = pw_weight.shape[0]
    site = Site("sep2d", family, (b, h, w, cin, cout), _dtype_name(x.dtype))
    if not _decide(site, x.dtype in _FLOAT_TYPES, x.device):
        return None
    _refuse_recording(site, x, dw_weight, pw_weight, bn_weight, bn_bias,
                      bn_mean, bn_var)
    dw9 = dw_weight.reshape(cin, 9).t().to(x.dtype).contiguous()
    pw2 = _route_weight(pw_weight, cout, cin, x.dtype)
    scale, shift = _fold_bn(bn_weight, bn_bias, bn_mean, bn_var, eps)
    return sep2d(x.contiguous(), dw9, pw2, scale, shift)


def route_pw1x1(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                eps: float, *, relu: bool, family: str):
    """The fused 1×1 ConvBN body for one site, or None. The conv weight is
    in the port's layout, (Cout, Cin, 1, 1); it is cast to x's type as the
    JAX route does."""
    b, h, w, cin = x.shape
    cout = conv_weight.shape[0]
    site = Site("pw1x1_relu" if relu else "pw1x1", family,
                (b, h, w, cin, cout), _dtype_name(x.dtype))
    if not _decide(site, x.dtype in _FLOAT_TYPES, x.device):
        return None
    _refuse_recording(site, x, conv_weight, bn_weight, bn_bias, bn_mean,
                      bn_var)
    w2 = _route_weight(conv_weight, cout, cin, x.dtype)
    scale, shift = _fold_bn(bn_weight, bn_bias, bn_mean, bn_var, eps)
    return pw1x1(x.contiguous(), w2, scale, shift, relu=relu)


def route_preproc(x, target_hw: Tuple[int, int], out_dtype, *,
                  family: str):
    """The fused cast + resize prologue for one resize, or None."""
    b, h, w, c = x.shape
    th, tw = int(target_hw[0]), int(target_hw[1])
    site = Site("preproc", family, (b, h, w, c, th, tw),
                f"{_dtype_name(x.dtype)}->{_dtype_name(out_dtype)}")
    feasible = x.dtype in _DTYPE_CODES and out_dtype in _FLOAT_TYPES
    if not _decide(site, feasible, x.device):
        return None
    _refuse_recording(site, x)
    return preproc_resize(x.contiguous(), (th, tw), out_dtype)
