"""Builds across processes: two processes that ask for one library at
once run its compiler once (``core/cuda_build.py``'s file lock), and a
process that may only load (a cluster worker) refuses to build."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sparkdl_tpu_torch.core import cuda_build

ROOT = Path(__file__).resolve().parent.parent

_ASK = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from sparkdl_tpu_torch.core import cuda_build
cuda_build.BUILD_DIR = Path(sys.argv[2])
while not Path(sys.argv[3]).exists():  # both start together
    time.sleep(0.01)
print(json.dumps(cuda_build.build_all(("image_loader",))))
"""


def _loader_builds() -> bool:
    if shutil.which("g++") is None:
        return False
    return all(os.path.exists(f"/usr/include/{h}")
               for h in ("jpeglib.h", "png.h"))


def test_two_processes_build_the_native_loader_once(tmp_path):
    if not _loader_builds():
        pytest.skip("g++ or the libjpeg/libpng headers are missing here")
    go = tmp_path / "go"
    build = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ASK, str(ROOT), str(build), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    go.write_text("")
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    seconds = sorted(float(o.strip().split(":")[1].rstrip("}"))
                     for o in outs)
    assert seconds[0] == 0.0 < seconds[1]  # one compiled, one waited
    libs = list(build.glob("libimage_loader_*.so"))
    assert len(libs) == 1
    assert not list(build.glob("*.tmp*"))


def test_a_process_that_may_only_load_refuses_to_build(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_builds_forbidden", True)
    with pytest.raises(RuntimeError, match="may only load"):
        cuda_build.build_all(("sep2d",))
    assert not list(tmp_path.glob("*.so"))
