"""Build and load the port's hand-written CUDA kernels and its native
host library.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. The host image loader (``native/image_loader.cc``, library
name ``image_loader``) compiles the same way with ``g++`` against
libjpeg and libpng, with the JAX package's flags (``-march=native``, so
its float resize rounds as that package's build does on the same host).
Builds happen at first use, into ``build/sparkdl_tpu_torch/`` beside
the package, keyed by a hash of the sources (and the shared headers)
and the flags, a host library's key also by what ``-march=native``
means on the building host (a library copied to another host is built
again there). So a fresh checkout builds everything it runs and a
changed source rebuilds. Builds in one process serialize on a thread
lock, and builds across processes on a file lock per library
(``fcntl.flock`` on ``build/sparkdl_tpu_torch/.<name>.lock``): a second
process asking for a library that another is building waits, then finds
it built and only loads it. Each build writes a file of its own and
renames it into place. :func:`build_all` starts one compiler per source,
all at once. A cluster worker calls :func:`forbid_builds`: its
coordinator built every library before it spawned, so a worker only
loads.
Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparkdl_tpu_torch"
KERNEL_SOURCES = ("sep2d", "preproc_resize", "pw1x1", "probes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
#: host libraries built with g++: name -> (source, link flags)
HOST_SOURCES = {
    "image_loader": (Path(__file__).resolve().parent.parent / "native"
                     / "image_loader.cc", ["-ljpeg", "-lpng", "-lpthread"]),
}
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = cached)
build_seconds: Dict[str, float] = {}
_builds_forbidden = False


def forbid_builds() -> None:
    """From now on, a library that is not built raises instead of
    building (a cluster worker: its coordinator builds before spawning)."""
    global _builds_forbidden
    _builds_forbidden = True


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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's native host library "
                           "builds on a machine with a C++ compiler")
    return found


@functools.lru_cache(maxsize=None)
def _native_arch() -> str:
    """The machine flags ``-march=native`` expands to on this host, as
    g++ reports them: the host's part of a host library's key."""
    out = subprocess.run([_gxx(), "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull], capture_output=True, text=True,
                         timeout=120)
    line = next((ln for ln in out.stderr.splitlines()
                 if "-march=" in ln and "cc1" in ln), "")
    return " ".join(t for t in line.split() if t.startswith("-m"))


def _sources_and_flags(name: str):
    if name in HOST_SOURCES:
        source, libs = HOST_SOURCES[name]
        return [source], GXX_FLAGS + libs + [_native_arch()]
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")), NVCC_FLAGS


def _library_path(name: str) -> Path:
    sources, flags = _sources_and_flags(name)
    digest = hashlib.sha256()
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        source, libs = HOST_SOURCES[name]
        return [_gxx(), *GXX_FLAGS, str(source), "-o", str(out), *libs]
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start the compiler for one source; None when its library is
    already built."""
    target = _library_path(name)
    if target.exists():
        return None
    if _builds_forbidden:
        raise RuntimeError(
            f"{target.name} is not built, and this process may only load "
            "libraries (a cluster worker: its coordinator builds every "
            "library before it spawns one)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    log = target.with_suffix(".log")
    cmd = _command(name, tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, target, log, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, log, t0 = started
    out, _ = proc.communicate()
    log.write_bytes(out)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed (exit {proc.returncode}):\n"
            + out.decode(errors="replace")[-4000:])
    os.replace(tmp, target)
    build_seconds[name] = time.perf_counter() - t0


@contextlib.contextmanager
def _file_locks(names: Sequence[str]) -> Iterator[None]:
    """Hold the cross-process lock of each named library (taken in sorted
    order, so two processes never wait on each other)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    held = []
    try:
        for name in sorted(set(names)):
            f = open(BUILD_DIR / f".{name}.lock", "a+b")
            held.append(f)
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        yield
    finally:
        for f in reversed(held):
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            f.close()


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every named library in parallel (one nvcc each); returns the
    seconds each build took (0.0 for one already built, here or by
    another process while this one waited for it)."""
    with _lock:
        if all(_library_path(n).exists() for n in names):
            for n in names:
                build_seconds.setdefault(n, 0.0)
            return {n: build_seconds[n] for n in names}
        with _file_locks(names):
            started = {n: _start(n) for n in names}
            for n, s in started.items():
                if s is None:
                    build_seconds.setdefault(n, 0.0)
                else:
                    _finish(n, s)
    return {n: build_seconds[n] for n in names}


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or the host
    source named ``name``) lies, built or not."""
    return _library_path(name)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the library built from ``csrc/<name>.cu``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or the host source
    named ``name``), building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return _libs[name]
