"""Where the ``dw2d`` and ``sep2d_probe`` kernels spend their time on the card.

    python -m sparkdl_tpu_torch.experiments.probe_breakdown [--json PATH]

Builds variants of ``csrc/probes.cu`` with parts of the work taken out
(``nvcc`` into ``build/sparkdl_tpu_torch/probe_breakdown/``), runs each at
the probe's shape (B = 128: 47,104 × 728 bf16, pw 728 × 728) and prints
its CUDA-event time per call (mean of 30 calls after 3 warm-up calls):

- ``sep2d_probe``: ``full``, the kernel as it ships; ``no_depthwise``,
  the producers write zeros instead of the depthwise; ``no_product``, the
  consumers skip the ``wgmma`` product; ``no_pw_loads``, no TMA load of
  the pw stages; ``no_halo``, no TMA load of the x halos (the depthwise
  reads stale shared memory); ``skeleton``, all four out: the barriers,
  the tap weights and the epilogue;
- ``dw2d``: ``full``; ``no_arithmetic``, each row stores its centre tap
  (the halo staging, the barriers and the stores stay; the nine-tap sums
  and the window's other loads go); ``no_halo_load``, no TMA load of the
  halos.

A variant's answer is wrong by design; only ``full`` is checked against
the plain versions. Then the shipped ``sep2d_probe`` runs again under
each ring of ``probe.SEP_RINGS`` and in clusters of 1 and 2, and
``dw2d`` under each count of halo slots. Each variant patches the source at named
anchors and raises if one is gone, so a change to the kernels shows here
rather than measuring something else.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
from typing import Dict

import torch

from sparkdl_tpu_torch.core import cuda_build, kernels
from sparkdl_tpu_torch.experiments import probe

#: (anchor in probes.cu, its replacement when the part is taken out)
_SEP_CUTS = {
    "no_depthwise": [("if (c < C) {\n          dw_run<RUN, true>",
                      "if (false) {\n          dw_run<RUN, true>")],
    "no_product": [("            hp::wgmma_k16_mn256(",
                    "            if (0) hp::wgmma_k16_mn256(")],
    "no_pw_loads": [("hp::mbar_arrive_tx(&full[b.slot], B_BYTES);\n"
                     "            for (int p = rank",
                     "hp::mbar_arrive(&full[b.slot]);\n"
                     "            if (0) for (int p = rank")],
    "no_halo": [("    if (leader)\n      while (loaded < halo_slots",
                 "    if (0)\n      while (loaded < halo_slots"),
                ("wait_phase(&halo_full[h.slot], h.phase);",
                 "if (0) wait_phase(&halo_full[h.slot], 0);"),
                ("if (leader && loaded < total) load_next_halo();",
                 "if (0) load_next_halo();")],
}
_SEP_CUTS["skeleton"] = [c for name in ("no_depthwise", "no_product",
                                        "no_pw_loads", "no_halo")
                         for c in _SEP_CUTS[name]]
_DW_CUTS = {
    "no_arithmetic": [("      if (masks[i] >> j & 1) tap4(acc, "
                       "win[j / 3][j % 3], wk[j]);",
                       "      acc = win[1][1];")],
    "no_halo_load": [("  if (tid == 0)\n    for (int i = 0; i < slots && "
                      "i < my_tiles; ++i) load_halo(i);",
                      "  if (0)\n    for (int i = 0; i < slots && "
                      "i < my_tiles; ++i) load_halo(i);"),
                     ("wait_phase(&full[s], (i / slots) & 1);",
                      "if (0) wait_phase(&full[s], 0);"),
                     ("if (tid == 0 && i + slots < my_tiles) load_halo(",
                      "if (0) load_halo(")],
}
_VARIANTS = {**{f"sep_{k}": v for k, v in _SEP_CUTS.items()},
             **{f"dw_{k}": v for k, v in _DW_CUTS.items()}}


def _variant_source(cuts) -> str:
    src = (cuda_build.CSRC / "probes.cu").read_text()
    for anchor, replacement in cuts:
        if anchor not in src:
            raise RuntimeError(f"probes.cu changed: anchor {anchor!r} is "
                               "gone")
        src = src.replace(anchor, replacement)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    """One library per variant, built in parallel; ``full`` is the
    shipped library."""
    out_dir = cuda_build.BUILD_DIR / "probe_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in _VARIANTS.items():
        src = out_dir / f"probes_{name}.cu"
        src.write_text(_variant_source(cuts))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(out_dir / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {"full": cuda_build.library("probes")}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               + out.decode(errors="replace")[-3000:])
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    for lib in libs.values():
        for symbol in ("sparkdl_dw2d", "sparkdl_sep2d_probe"):
            fn = getattr(lib, symbol)
            fn.argtypes = probe._ARGTYPES[symbol]
            fn.restype = ctypes.c_int
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


def main(dev: torch.device) -> Dict[str, dict]:
    libs = build_variants()
    v = probe.operands(dev)
    x2, k9 = v["x2"], v["k9"]
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def dw_call(lib, plan):
        err = lib.sparkdl_dw2d(x2.data_ptr(), k9.data_ptr(), out.data_ptr(),
                               rows, probe.C, probe.P_PAD, probe.H, probe.W,
                               plan.bm, plan.halo_slots, plan.blocks, stream)
        kernels._raise_on_error(err, "dw2d")

    def sep_call(lib, plan):
        err = lib.sparkdl_sep2d_probe(
            x2.data_ptr(), k9.data_ptr(), v["pw"].data_ptr(),
            v["sc"].data_ptr(), v["sh"].data_ptr(), out.data_ptr(), rows,
            probe.C, probe.P_PAD, probe.H, probe.W, plan.a_slots,
            plan.stages, plan.halo_slots, plan.cluster, plan.blocks, stream)
        kernels._raise_on_error(err, "sep2d_probe")

    result = {}
    dw_plan = probe.plan_dw2d(rows)
    dw_call(libs["full"], dw_plan)
    assert probe.matches_plain("dw2d", out, probe.plain_dw2d(x2, k9))
    result["dw2d"] = {
        "plan": dw_plan.row(),
        "ms": {name: _event_ms(lambda: dw_call(libs[name], dw_plan))
               for name in ("full", *(f"dw_{k}" for k in _DW_CUTS))},
        "slots": {s: _event_ms(lambda: dw_call(
            libs["full"], dataclasses.replace(dw_plan, halo_slots=s)))
            for s in (2, 3, 4)}}
    print(json.dumps({"kernel": "dw2d", **result["dw2d"]}), flush=True)

    sep_plan = probe.plan_sep2d_probe(rows)
    sep_call(libs["full"], sep_plan)
    ref = probe.plain_sep2d_probe(x2, k9, v["pw"], v["sc"], v["sh"])
    assert probe.matches_plain("sep2d_probe", out, ref)
    rings, clusters = {}, {}
    for ring in probe.SEP_RINGS:
        plan = probe.plan_sep2d_probe(rows, ring=ring)
        rings["x".join(map(str, ring))] = _event_ms(
            lambda: sep_call(libs["full"], plan))
    for cluster in (1, 2):
        groups = -(-sep_plan.row_tiles // cluster)
        plan = dataclasses.replace(
            sep_plan, cluster=cluster, tiles=groups * cluster,
            blocks=min(groups, kernels.SMS // cluster) * cluster)
        clusters[cluster] = _event_ms(lambda: sep_call(libs["full"], plan))
    result["sep2d_probe"] = {
        "plan": sep_plan.row(),
        "ms": {name: _event_ms(lambda: sep_call(libs[name], sep_plan))
               for name in ("full", *(f"sep_{k}" for k in _SEP_CUTS))},
        "rings": rings, "clusters": clusters}
    print(json.dumps({"kernel": "sep2d_probe", **result["sep2d_probe"]}),
          flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_breakdown: needs an NVIDIA card")
    rows_out = main(torch.device("cuda"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows_out, f, indent=1)
