"""The SASS of two checkouts' kernel libraries, compared kernel by kernel.

    python -m sparkdl_tpu_torch.experiments.sass_diff OTHER [--json PATH]

``OTHER`` is another checkout (for instance the parent commit, unpacked
with ``git archive``). Each checkout builds its ``csrc/*.cu`` libraries
into its own ``build/`` (a child process in that checkout), then
``cuobjdump -sass`` lists every kernel of every library. Two kernels of
one mangled name (less the per-build hash of an anonymous namespace) are
equal when their instructions are (the address column and the encoding
comments are left out).
Prints one JSON row per library: the kernels equal in both, those that
differ, and those in one checkout only; needs ``nvcc`` and ``cuobjdump``
(the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
_CHILD = """
import json
from sparkdl_tpu_torch.core import cuda_build
cuda_build.build_all()
print(json.dumps({n: str(cuda_build.library_path(n))
                  for n in cuda_build.KERNEL_SOURCES}))
"""
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
#: the per-build hash of an anonymous namespace in a mangled name
_UNIQUE = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")


def libraries(checkout: Path) -> Dict[str, str]:
    """Build the checkout's libraries; their paths by source name."""
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           + proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def kernels(path: str) -> Dict[str, List[str]]:
    """Each kernel's instructions (mangled name -> lines)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out: Dict[str, List[str]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _UNIQUE.sub("_GLOBAL__N__", line.split("Function :", 1)[1]
                               .strip())
            out[name] = []
        elif name is not None and _ADDRESS.search(line):
            text = _ENCODING.sub("", _ADDRESS.sub("", line)).strip()
            if text:
                out[name].append(text)
    return out


def main(other: Path) -> List[dict]:
    mine, theirs = libraries(ROOT), libraries(other)
    rows = []
    for source in sorted(set(mine) & set(theirs)):
        a, b = kernels(mine[source]), kernels(theirs[source])
        row = {"library": source,
               "equal": sorted(k for k in set(a) & set(b) if a[k] == b[k]),
               "differ": sorted(k for k in set(a) & set(b) if a[k] != b[k]),
               "only_this": sorted(set(a) - set(b)),
               "only_other": sorted(set(b) - set(a))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other checkout")
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    result = main(args.other.resolve())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
