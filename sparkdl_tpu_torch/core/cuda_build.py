"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. Builds happen at first use, into ``build/sparkdl_tpu_torch/``
beside the package, keyed by a hash of the sources (and the shared
headers), so a fresh checkout builds everything it runs and a changed
source rebuilds. :func:`build_all` starts one ``nvcc`` per source, all
at once. Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparkdl_tpu_torch"
KERNEL_SOURCES = ("sep2d", "preproc_resize", "pw1x1", "probes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = cached)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build on a machine with "
        "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, target, log, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, log, t0 = started
    out, _ = proc.communicate()
    log.write_bytes(out)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            + out.decode(errors="replace")[-4000:])
    os.replace(tmp, target)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every named library in parallel (one nvcc each); returns the
    seconds each build took (0.0 for one already built)."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is None:
                build_seconds.setdefault(n, 0.0)
            else:
                _finish(n, s)
    return {n: build_seconds[n] for n in names}


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lies (built or
    not)."""
    return _library_path(name)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the library built from ``csrc/<name>.cu``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return _libs[name]
