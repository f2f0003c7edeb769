"""Where the time of ``sep2d``'s two bodies goes, on the card.

    python -m sparkdl_tpu_torch.experiments.sep2d_breakdown [--json PATH]
        [--body bf16|f32|both]

Builds variants of the kernel sources with parts of the work taken out
(``nvcc`` into ``build/sparkdl_tpu_torch/breakdown/``), runs each at
Xception's shapes at batch 16 and prints its CUDA-event time per call
(mean of 30 calls after 3 warm-up calls). The tensor-core body (bf16,
``csrc/sep2d.cu``):

- ``full``: the kernel as it ships;
- ``no_depthwise``: the producers write zeros instead of the depthwise;
- ``no_product``: the consumers skip the ``wgmma`` product;
- ``no_pw_loads``: no TMA load of the pw slices;
- ``no_halo``: no TMA load of the x halos (the depthwise reads stale
  shared memory);
- ``skeleton``: all four out: the barriers, the tap weights and the
  epilogue.

The float32 SIMT mainloop (``csrc/simt_f32.cuh``, shared with ``pw1x1``):

- ``full``; ``no_depthwise`` (the first pass of a unit leaves D as it
  is); ``no_product`` (no FMA loop); ``no_loads`` (no ``cp.async``: the
  ring keeps stale shared memory); ``skeleton`` (all three out: the walk,
  the barriers and the epilogue's stores); ``product_only`` (the product
  on stale shared memory: no loads, no depthwise).

A variant's answer is wrong by design; only ``full`` is checked against
``plain_sep2d``. Then the shipped kernel runs again under each ring that
fits: the bf16 body's (halo slots, stages) of ``kernels._SEP2D_RINGS``,
the float32 body's 2-4 stages, and the float32 body at the three tile
shapes its plan weighs cheapest (``kernels._f32_candidates``). Each
variant patches the source at named anchors and raises if one is gone,
so a change to the kernel shows here rather than measuring something
else. The float32 rows also count the instructions of each float32
kernel's SASS (``cuobjdump -sass``: ``FFMA``, ``LDS``, local-memory
``LDL``/``STL``, ``BAR``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
from typing import Dict, List

import torch

from sparkdl_tpu_torch.core import cuda_build, kernels

SHAPES = [(147, 64, 128), (37, 256, 728), (19, 728, 728), (10, 1536, 2048)]
BATCH = 16

#: (file, anchor, its replacement when the part is taken out)
_BF16_CUTS = {
    "no_depthwise": [("sep2d.cu",
                      "for (int tap = 0; tap < 9; ++tap) {\n#pragma unroll\n"
                      "        for (int i = 0;",
                      "for (int tap = 0; tap < 0; ++tap) {\n#pragma unroll\n"
                      "        for (int i = 0;")],
    "no_product": [("sep2d.cu", "hp::mma_stage<NW>(acc,",
                    "if (0) hp::mma_stage<NW>(acc,")],
    "no_pw_loads": [("sep2d.cu",
                     "hp::mbar_arrive_tx(&full[s], B_BYTES);\n"
                     "        hp::tma_load_2d(b_tiles",
                     "hp::mbar_arrive(&full[s]);\n"
                     "        if (0) hp::tma_load_2d(b_tiles")],
    "no_halo": [("sep2d.cu",
                 "    if (leader)\n      for (int k = 0; k < halo_slots",
                 "    if (0)\n      for (int k = 0; k < halo_slots"),
                ("sep2d.cu",
                 "hp::mbar_wait(&halo_full[slot], (k / halo_slots) & 1);",
                 "if (0) hp::mbar_wait(&halo_full[slot], 0);"),
                ("sep2d.cu",
                 "if (leader && k + halo_slots < my_chunks) load_halo(",
                 "if (0) load_halo(")],
}
_BF16_CUTS["skeleton"] = [c for name in ("no_depthwise", "no_product",
                                         "no_pw_loads", "no_halo")
                          for c in _BF16_CUTS[name]]
_F32_CUTS = {
    "no_depthwise": [("simt_f32.cuh",
                      "        depthwise(p, halo, halo + hfloats,",
                      "        if (0) depthwise(p, halo, halo + hfloats,")],
    "no_product": [("simt_f32.cuh",
                    "    product<TX>(acc, a, p.ty * dp, b + 4 * tx);",
                    "    if (0) product<TX>(acc, a, p.ty * dp, b + 4 * tx);")],
    "no_loads": [("simt_f32.cuh", "  const int per = vec ? 4 : 1;\n",
                  "  if (nrows >= 0) return;\n"
                  "  const int per = vec ? 4 : 1;\n"),
                 ("simt_f32.cuh", "      if (p.tma) {\n        if (tid == 0) {",
                  "      if (p.tma) {\n        if (false) {"),
                 ("simt_f32.cuh", "        } else {\n          hopper::mbar_arrive(bar);\n        }\n        return;",
                  "        }\n          hopper::mbar_arrive(bar);\n        return;")],
}
_F32_CUTS["skeleton"] = [c for name in ("no_depthwise", "no_product",
                                        "no_loads")
                         for c in _F32_CUTS[name]]
_F32_CUTS["product_only"] = _F32_CUTS["no_depthwise"] + _F32_CUTS["no_loads"]
_CUTS = {"bf16": _BF16_CUTS, "f32": _F32_CUTS}


def _variant_dir(body: str, name: str, cuts):
    """A copy of sep2d.cu and simt_f32.cuh with ``cuts`` applied; the
    copy's own header comes before ``csrc/`` for its quoted include."""
    out_dir = cuda_build.BUILD_DIR / "breakdown" / f"{body}_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {f: (cuda_build.CSRC / f).read_text()
               for f in ("sep2d.cu", "simt_f32.cuh")}
    for f, anchor, replacement in cuts:
        if anchor not in sources[f]:
            raise RuntimeError(f"{f} changed: anchor {anchor!r} is gone")
        sources[f] = sources[f].replace(anchor, replacement)
    for f, text in sources.items():
        (out_dir / f).write_text(text)
    return out_dir


def build_variants(body: str) -> Dict[str, ctypes.CDLL]:
    """One library per variant of ``body`` ("bf16" or "f32"), built in
    parallel; ``full`` is the shipped library."""
    procs = {}
    for name, cuts in _CUTS[body].items():
        out_dir = _variant_dir(body, name, cuts)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(out_dir / f"{body}_{name}.so"),
               str(out_dir / "sep2d.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), out_dir)
    libs = {"full": cuda_build.library("sep2d")}
    for name, (proc, out_dir) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {body} {name}:\n"
                               + out.decode(errors="replace")[-3000:])
        libs[name] = ctypes.CDLL(str(out_dir / f"{body}_{name}.so"))
    for lib in libs.values():
        lib.sparkdl_sep2d.argtypes = kernels._sep2d_fn().argtypes
        lib.sparkdl_sep2d.restype = ctypes.c_int
    return libs


def sass_counts(path) -> Dict[str, Dict[str, int]]:
    """Instructions by kind in each float32 mainloop kernel of a library
    (``cuobjdump -sass``), by mangled name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    kinds = ("FFMA", "LDS", "LDL", "STL", "BAR", "LDGSTS")
    counts, function = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            function = name if "simt32" in name else None
            if function:
                counts[function] = {k: 0 for k in kinds + ("total",)}
        elif function and "*/" in line and ";" in line:
            words = [w for w in line.split("*/", 1)[1].split()
                     if not w.startswith("@")]
            if not words:
                continue
            op = words[0].split(".")[0]
            counts[function]["total"] += 1
            if op in kinds:
                counts[function][op] += 1
    return counts


def _event_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed(fn):
    """``_event_ms(fn)``, or the launch error's text where ``fn``
    raises (one variant that cannot launch does not hide the others)."""
    try:
        return _event_ms(fn)
    except RuntimeError as e:
        return str(e)


def _call(lib, plan, x, dw9, w_lay, scale, shift, out):
    b, hw, _, cin = x.shape
    cout = out.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sparkdl_sep2d(
        x.data_ptr(), dw9.data_ptr(), w_lay.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), b, hw, hw, cin, cout, 0,
        kernels._DTYPE_CODES[x.dtype], kernels._BODY_CODES[plan.body],
        plan.bn, plan.stages, plan.halo_slots, plan.bm, plan.groups,
        int(plan.layout == "resident"), plan.producers, plan.grid[0], stream)
    kernels._raise_on_error(err, "sep2d")


def _rings(plan, hw, cin):
    """The other rings of ``plan`` that fit, by label."""
    if plan.body == "wgmma":
        halo = kernels.sep2d_halo(hw)[2]
        return {f"{slots}x{stages}": dataclasses.replace(
                    plan, halo_slots=slots, stages=stages)
                for slots, stages in kernels._SEP2D_RINGS
                if kernels._sep2d_smem(plan.bn, stages, slots, halo)
                <= kernels.SMEM_LIMIT}
    resident = plan.layout == "resident"
    return {f"stages{stages}": dataclasses.replace(plan, stages=stages)
            for stages in range(2, kernels._F32_MAX_STAGES + 1)
            if kernels._f32_smem(True, resident, plan.bm, plan.bn, hw, stages,
                                 plan.chunks, 1) <= kernels.SMEM_LIMIT
            and not (resident and stages > plan.chunks)}


def main(dev: torch.device, bodies=("bf16", "f32")) -> List[dict]:
    rows = []
    for body in bodies:
        libs = build_variants(body)
        dtype = torch.bfloat16 if body == "bf16" else torch.float32
        sass = (sass_counts(cuda_build.library_path("sep2d"))
                if body == "f32" else None)
        for hw, cin, cout in SHAPES:
            gen = torch.Generator().manual_seed(0)
            x = torch.randn(BATCH, hw, hw, cin, generator=gen).to(dev, dtype)
            dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(dev, dtype)
            w_nk = (torch.randn(cout, cin, generator=gen)
                    / cin ** 0.5).to(dev, dtype)
            scale = torch.ones(cout, device=dev)
            shift = torch.zeros(cout, device=dev)
            out = torch.empty(BATCH, hw, hw, cout, device=dev, dtype=dtype)
            plan = kernels.plan_sep2d(BATCH, hw, hw, cin, cout, dtype)
            # the body's own weight layout (the float32 body's is (Cin, Cout))
            w_lay = kernels._weight_layout(w_nk.t(), x, "pw")
            args = (x, dw9, w_lay, scale, shift, out)
            _call(libs["full"], plan, *args)
            ref = kernels.plain_sep2d(x, dw9, w_nk.t(), scale, shift)
            err = float((out.float() - ref.float()).abs().max())
            limit = (kernels.BF16_TOLERANCE if body == "bf16"
                     else 1e-5 * max(1.0, float(ref.abs().max())))
            assert err <= limit, (body, hw, cin, cout, err)
            row = {"body": plan.body, "shape": [BATCH, hw, hw, cin, cout],
                   "max_abs_err": err,
                   "plan": [plan.bm, plan.bn, plan.stages, plan.halo_slots,
                            plan.layout, plan.units, plan.grid[0]],
                   "ms": {name: _timed(lambda: _call(lib, plan, *args))
                          for name, lib in libs.items()},
                   "rings": {label: _timed(lambda: _call(
                       libs["full"], other, *args))
                       for label, other in _rings(plan, hw, cin).items()}}
            if body == "f32":
                ranked = sorted(kernels._f32_candidates(True, BATCH * hw * hw,
                                                        cin, cout, hw),
                                key=lambda cp: cp[0])[:3]
                row["shapes"] = {
                    f"{p.bm}x{p.bn} {p.layout} g{p.groups} s{p.stages}":
                    _timed(lambda: _call(libs["full"], p, *args))
                    for _, p in ranked}
                row["sass"] = sass
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    parser.add_argument("--body", choices=("bf16", "f32", "both"),
                        default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sep2d_breakdown: needs an NVIDIA card")
    result = main(torch.device("cuda"),
                  ("bf16", "f32") if args.body == "both" else (args.body,))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
