"""Kernel times of two checkouts of the repo on one card, taken in turns.

    python -m sparkdl_tpu_torch.experiments.same_card OTHER [--json PATH]

``OTHER`` is another checkout (for instance the parent commit, unpacked
with ``git archive``). In the order OTHER, this, this, OTHER, a child
process per turn imports that checkout's ``chip_smoke.py`` and port,
builds its kernels into its own ``build/`` and runs the kernel checks
(``check_sep2d``, ``check_pw1x1``, ``check_preproc`` and, where the
checkout has it, ``check_unaligned_bodies``: each kernel against its
plain version at its path's shapes, CUDA-event ms and, from
``torch.profiler``, device ms: a kernel of a few µs is hidden by its
host launch in event ms) and the probe script's ``main()`` (the three
probes and their yardsticks, µs per application chained in CUDA
graphs). Prints one JSON row per (kernel, shape, dtype, relu,
body) with the four times of each kind, in turn order (None in the
turns of a checkout without that row); needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

#: run in the checkout's root, which comes first on sys.path
_CHILD = """
import json, sys
import torch
import chip_smoke as cs
import sparkdl_tpu_torch as s
from sparkdl_tpu_torch.core import cuda_build, kernels
from sparkdl_tpu_torch.experiments import probe
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.PROFILE = True  # device ms from torch.profiler beside the event ms
cuda_build.build_all()
dev = torch.device("cuda")
s.EngineConfig.pallas_kernels = "force"
cs.check_sep2d(kernels, dev)
cs.check_pw1x1(kernels, dev)
cs.check_preproc(kernels, dev)
if hasattr(cs, "check_unaligned_bodies"):
    cs.check_unaligned_bodies(kernels, dev)
times = probe.main(dev)
print(json.dumps({"phase": "probe_main", "us_per_app": {
    k: v["us_per_app"] for k, v in times.items()}}), flush=True)
"""

ROOT = Path(__file__).resolve().parents[2]


def run_child(checkout: Path, code: str) -> str:
    """Run ``code`` in a child Python in ``checkout`` (its root comes
    first on ``sys.path``); returns the child's standard output."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           + proc.stderr[-3000:])
    return proc.stdout


def in_turns(other: Path, code: str) -> List[Tuple[str, str]]:
    """``code`` run in the order OTHER, this, this, OTHER, a child process
    per turn: ``(turn label, the child's standard output)`` in that
    order. Turns in this order put a drift of the card's clocks on both
    checkouts alike."""
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    return [(label, run_child(path, code)) for label, path in turns]


def kernel_times(stdout: str) -> Dict[str, Dict[str, float]]:
    """The kernel times of one turn: ``{row key: {"ms": event ms,
    "device_ms": device ms}}`` (the probes' µs per application chained
    in CUDA graphs, under "ms")."""
    times = {}
    for line in stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if row.get("phase") == "kernel_check":
            key = [row["kernel"], row["shape"], row["dtype"],
                   row.get("relu"), row.get("body")]
            times[json.dumps(key)] = {"ms": row["ms"],
                                      "device_ms": row.get("device_ms")}
        elif row.get("phase") == "probe_main":
            for name, us in row["us_per_app"].items():
                times[json.dumps(["probe", name])] = {"ms": us / 1e3}
    return times


def main(other: Path) -> List[dict]:
    turns = in_turns(other, _CHILD)
    results = [kernel_times(stdout) for _, stdout in turns]
    rows = []
    # rows of either checkout, the other's first (a row only one has
    # shows None in the other's turns)
    for key in dict.fromkeys(k for result in results for k in result):
        rows.append({"key": json.loads(key), **{
            kind: {f"{i}_{label}": results[i].get(key, {}).get(kind)
                   for i, (label, _) in enumerate(turns)}
            for kind in ("ms", "device_ms")}})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other checkout")
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    out = main(args.other.resolve())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
