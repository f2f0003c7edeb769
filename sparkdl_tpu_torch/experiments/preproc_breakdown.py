"""Where the time of ``preproc_resize`` goes, on the card.

    python -m sparkdl_tpu_torch.experiments.preproc_breakdown [--json PATH]

Builds variants of ``csrc/preproc_resize.cu`` with parts of the work
taken out (``nvcc`` into ``build/sparkdl_tpu_torch/breakdown/``), runs
each on 16 images resized to 299×299 (the featurize path's sources,
256×256 and 512×384, uint8 → float32, and 256×256 uint8 → bf16) and
prints its device time per call (20 calls captured in a CUDA graph,
replayed 10 times between CUDA events: the host's ~25 µs a call would
hide a kernel of ~12 µs):

- ``full``: the kernel as it ships;
- ``no_staging``: no bulk copy and no head or tail load (the passes read
  stale shared memory);
- ``no_vertical``: the vertical pass writes nothing;
- ``no_horizontal``: the horizontal pass writes nothing;
- ``no_stores``: no store to device memory;
- ``stores_only``: ``no_staging``, ``no_vertical`` and ``no_horizontal``
  together (the launch, the barriers and the stores of stale shared
  memory);
- ``skeleton``: all four out (the launch, the tables and the barriers).

A variant's answer is wrong by design; only ``full`` is checked, bit for
bit, against the exact-order resize. Then the shipped kernel runs under
plans pinned to each band height (``plan_preproc(band_rows=...)``),
with each plan's shared memory and grid beside its time, and
``cast + F.interpolate`` (the library call) is timed as a yardstick.
Each variant patches the source at named anchors and raises if one is
gone, so a change to the kernel shows here rather than measuring
something else. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.core import cuda_build, kernels

BATCH = 16
TARGET = (299, 299)
#: (source H, W, output dtype)
CASES = [(256, 256, torch.float32), (512, 384, torch.float32),
         (256, 256, torch.bfloat16)]
BAND_ROWS = (1, 2, 4, 8, 16)
SOURCE = "preproc_resize.cu"

#: (anchor, its replacement when the part is taken out)
_CUTS = {
    "no_staging": [
        ("if (s.lo < s.hi) bytes +=", "if (false) bytes +="),
        ("        if (s.lo < s.hi)\n          bulk_load(",
         "        if (false)\n          bulk_load("),
        ("      if (ok)\n        *reinterpret_cast<Tin*>",
         "      if (false)\n        *reinterpret_cast<Tin*>")],
    "no_vertical": [("    for (int q = tid; q < p.NXC; q += THREADS) {",
                     "    for (int q = tid; q < 0; q += THREADS) {")],
    "no_horizontal": [("for (int r = 0; r < rows; ++r, tr += p.NXC, "
                       "orow += p.TWC)",
                       "for (int r = 0; r < 0; ++r, tr += p.NXC, "
                       "orow += p.TWC)")],
    "no_stores": [("  // Stores: the aligned interior",
                   "  if (p.R > 0) return;\n"
                   "  // Stores: the aligned interior")],
}
_CUTS["stores_only"] = (_CUTS["no_staging"] + _CUTS["no_vertical"]
                        + _CUTS["no_horizontal"])
_CUTS["skeleton"] = _CUTS["stores_only"] + _CUTS["no_stores"]


def build_variants(candidates: Sequence[Path] = ()) -> Dict[str, ctypes.CDLL]:
    """One library per variant, and one per candidate source (another
    ``preproc_resize.cu`` with the same C interface, under its file's
    path), built in parallel; ``full`` is the shipped library."""
    procs = {}
    jobs = [(name, cuda_build.CSRC / SOURCE, cuts)
            for name, cuts in _CUTS.items()]
    jobs += [(str(path), path, []) for path in candidates]
    for i, (name, path, cuts) in enumerate(jobs):
        out_dir = cuda_build.BUILD_DIR / "breakdown" / f"preproc_{i}"
        out_dir.mkdir(parents=True, exist_ok=True)
        text = path.read_text()
        for anchor, replacement in cuts:
            if anchor not in text:
                raise RuntimeError(f"{SOURCE} changed: anchor {anchor!r} "
                                   "is gone")
            text = text.replace(anchor, replacement)
        (out_dir / SOURCE).write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(out_dir / "variant.so"),
               str(out_dir / SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), out_dir)
    full = kernels._preproc_fn()
    libs = {"full": full}
    for name, (proc, out_dir) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               + out.decode(errors="replace")[-3000:])
        fn = ctypes.CDLL(str(out_dir / "variant.so")).sparkdl_preproc_resize
        fn.argtypes, fn.restype = full.argtypes, full.restype
        libs[name] = fn
    return libs


def _graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events (no host
    launch gaps: a call here is ~12 µs on the card and ~25 µs of host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _timed(fn):
    """``_graph_ms(fn)``, or the launch error's text where ``fn`` raises
    (a plan one variant cannot run does not hide the others)."""
    try:
        return _graph_ms(fn)
    except RuntimeError as e:
        torch.cuda.synchronize()
        return str(e)


def exact_order(x: torch.Tensor, th: int, tw: int, out_dtype):
    """The kernel's arithmetic as separate PyTorch ops on ``x``'s device:
    the two row taps of ``kernels._resize_taps`` gathered, multiplied and
    added in float32, then the two column taps, each operation rounded
    on its own, then one cast: what the kernel must equal bit for bit."""
    _, h, w, _ = x.shape
    (yt, yw), (xt, xw) = (kernels._resize_taps(h, th),
                          kernels._resize_taps(w, tw))
    yt, xt = (torch.from_numpy(a).long().to(x.device) for a in (yt, xt))
    yw, xw = (torch.from_numpy(a).to(x.device) for a in (yw, xw))
    xf = x.float()
    t = (yw[:, 0, None, None] * xf[:, yt[:, 0]]
         + yw[:, 1, None, None] * xf[:, yt[:, 1]])
    y = xw[:, 0, None] * t[:, :, xt[:, 0]] + xw[:, 1, None] * t[:, :, xt[:, 1]]
    return y.to(out_dtype)


def main(dev: torch.device, candidates: Sequence[Path] = ()) -> List[dict]:
    libs = build_variants(candidates)
    rows = []
    for h, w, out_dtype in CASES:
        gen = torch.Generator().manual_seed(1)
        x = torch.randint(0, 256, (BATCH, h, w, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        out = torch.empty((BATCH, *TARGET, 3), dtype=out_dtype, device=dev)
        plan = kernels.plan_preproc(BATCH, h, w, 3, *TARGET, torch.uint8,
                                    out_dtype)
        want = exact_order(x, *TARGET, out_dtype)
        exact = {}
        for name in ["full", *map(str, candidates)]:
            out.zero_()
            kernels.launch_preproc(libs[name], x, out, plan)
            torch.cuda.synchronize()
            exact[name] = torch.equal(out, want)
        assert exact["full"], f"{h}x{w}: the shipped kernel is not the " \
            "exact order"
        bands = {}
        for name in ["full", *map(str, candidates)]:
            for r in BAND_ROWS:
                pinned = kernels.plan_preproc(BATCH, h, w, 3, *TARGET,
                                              torch.uint8, out_dtype,
                                              band_rows=r)
                bands[f"{name} {r}"] = {
                    "ms": _timed(lambda: kernels.launch_preproc(
                        libs[name], x, out, pinned)),
                    "smem": pinned.smem, "blocks": pinned.blocks}
        xn = x.permute(0, 3, 1, 2)
        row = {"shape": [BATCH, h, w, 3, *TARGET],
               "dtype": f"uint8->{str(out_dtype).replace('torch.', '')}",
               "plan": {"band_rows": plan.band_rows, "smem": plan.smem,
                        "grid": list(plan.grid),
                        "staged_bytes": plan.staged_bytes},
               "ms": {name: _timed(lambda: kernels.launch_preproc(
                   fn, x, out, plan)) for name, fn in libs.items()},
               "band_rows": bands, "exact_order": exact,
               "library_ms": _graph_ms(lambda: F.interpolate(
                   xn.to(out_dtype), size=TARGET, mode="bilinear",
                   align_corners=False, antialias=False))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    parser.add_argument("--candidate", type=Path, action="append",
                        default=[], help="another preproc_resize.cu to time "
                        "beside the shipped one (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("preproc_breakdown: needs an NVIDIA card")
    result = main(torch.device("cuda"),
                  [p.resolve() for p in args.candidate])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
