"""Where the time of ``sep2d``'s tensor-core body goes, on the card.

    python -m sparkdl_tpu_torch.experiments.sep2d_breakdown [--json PATH]

Builds variants of ``csrc/sep2d.cu`` with parts of the work taken out
(``nvcc`` into ``build/sparkdl_tpu_torch/breakdown/``), runs each at
Xception's bf16 shapes at batch 16 and prints its CUDA-event time per
call (mean of 30 calls after 3 warm-up calls):

- ``full``: the kernel as it ships;
- ``no_depthwise``: the producers write zeros instead of the depthwise;
- ``no_product``: the consumers skip the ``wgmma`` product;
- ``no_pw_loads``: no TMA load of the pw slices;
- ``no_halo``: no TMA load of the x halos (the depthwise reads stale
  shared memory);
- ``skeleton``: all four out: the barriers, the tap weights and the
  epilogue.

A variant's answer is wrong by design; only ``full`` is checked against
``plain_sep2d``. Then the shipped kernel runs again under each (halo
slots, stages) ring that fits (the plan's choice is the first of
``kernels._SEP2D_RINGS`` that fits). Each variant patches the source at
named anchors and raises if one is gone, so a change to the kernel shows
here rather than measuring something else.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List

import torch

from sparkdl_tpu_torch.core import cuda_build, kernels

SHAPES = [(147, 64, 128), (37, 256, 728), (19, 728, 728), (10, 1536, 2048)]
BATCH = 16

#: (anchor in sep2d.cu, its replacement when the part is taken out)
_CUTS = {
    "no_depthwise": [("for (int tap = 0; tap < 9; ++tap) {\n#pragma unroll\n"
                      "        for (int i = 0;",
                      "for (int tap = 0; tap < 0; ++tap) {\n#pragma unroll\n"
                      "        for (int i = 0;")],
    "no_product": [("hp::mma_stage<NW>(acc,", "if (0) hp::mma_stage<NW>(acc,")],
    "no_pw_loads": [("hp::mbar_arrive_tx(&full[s], B_BYTES);\n"
                     "        hp::tma_load_2d(b_tiles",
                     "hp::mbar_arrive(&full[s]);\n"
                     "        if (0) hp::tma_load_2d(b_tiles")],
    "no_halo": [("    if (leader)\n      for (int k = 0; k < halo_slots",
                 "    if (0)\n      for (int k = 0; k < halo_slots"),
                ("hp::mbar_wait(&halo_full[slot], (k / halo_slots) & 1);",
                 "if (0) hp::mbar_wait(&halo_full[slot], 0);"),
                ("if (leader && k + halo_slots < my_chunks) load_halo(",
                 "if (0) load_halo(")],
}
_CUTS["skeleton"] = [c for name in ("no_depthwise", "no_product",
                                    "no_pw_loads", "no_halo")
                     for c in _CUTS[name]]


def _variant_source(cuts) -> str:
    src = (cuda_build.CSRC / "sep2d.cu").read_text()
    for anchor, replacement in cuts:
        if anchor not in src:
            raise RuntimeError(f"sep2d.cu changed: anchor {anchor!r} is gone")
        src = src.replace(anchor, replacement)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    """One library per variant, built in parallel; ``full`` is the
    shipped library."""
    out_dir = cuda_build.BUILD_DIR / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in _CUTS.items():
        src = out_dir / f"sep2d_{name}.cu"
        src.write_text(_variant_source(cuts))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(out_dir / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {"full": cuda_build.library("sep2d")}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               + out.decode(errors="replace")[-3000:])
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    for lib in libs.values():
        lib.sparkdl_sep2d.argtypes = kernels._sep2d_fn().argtypes
        lib.sparkdl_sep2d.restype = ctypes.c_int
    return libs


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


def main(dev: torch.device) -> List[dict]:
    libs = build_variants()
    rows = []
    for hw, cin, cout in SHAPES:
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(BATCH, hw, hw, cin, generator=gen).to(
            dev, torch.bfloat16)
        dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(dev,
                                                             torch.bfloat16)
        w_nk = (torch.randn(cout, cin, generator=gen) / cin ** 0.5).to(
            dev, torch.bfloat16)
        scale = torch.ones(cout, device=dev)
        shift = torch.zeros(cout, device=dev)
        out = torch.empty(BATCH, hw, hw, cout, device=dev,
                          dtype=torch.bfloat16)
        plan = kernels.plan_sep2d(BATCH, hw, hw, cin, cout, torch.bfloat16)

        def call(lib, slots=plan.halo_slots, stages=plan.stages):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sparkdl_sep2d(
                x.data_ptr(), dw9.data_ptr(), w_nk.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), out.data_ptr(), BATCH,
                hw, hw, cin, cout, 0, 1, 2, plan.bn, stages, slots, stream)
            kernels._raise_on_error(err, "sep2d")

        call(libs["full"])
        ref = kernels.plain_sep2d(x, dw9, w_nk.t(), scale, shift)
        err = float((out.float() - ref.float()).abs().max())
        assert err <= kernels.BF16_TOLERANCE, err
        row = {"shape": [BATCH, hw, hw, cin, cout], "max_abs_err": err,
               "plan": [plan.halo_slots, plan.stages],
               "ms": {name: _event_ms(lambda: call(lib))
                      for name, lib in libs.items()}, "rings": {}}
        for slots, stages in kernels._SEP2D_RINGS:
            if kernels._sep2d_smem(plan.bn, stages, slots,
                                   kernels.sep2d_halo(hw)[2]) \
                    <= kernels.SMEM_LIMIT:
                row["rings"][f"{slots}x{stages}"] = _event_ms(
                    lambda: call(libs["full"], slots, stages))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sep2d_breakdown: needs an NVIDIA card")
    result = main(torch.device("cuda"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
