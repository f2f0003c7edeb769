"""ctypes binding of the native host image loader (``image_loader.cc``).

The library builds with ``g++`` at first use into
``build/sparkdl_tpu_torch/`` (``core/cuda_build.py``, library name
``image_loader``), against libjpeg and libpng. Where the compiler or
their headers are missing the build fails once per process,
:func:`available` is False (:data:`unavailable_reason` says why) and
every function here returns None, so callers take Pillow: the loader
is a host codec with the same contract either way, not a kernel of the
card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

LIBRARY = "image_loader"

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False
#: why the library could not be built or loaded (None while it can)
unavailable_reason: Optional[str] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sdl_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              _intp, _intp, _intp]
    lib.sdl_probe.restype = ctypes.c_int
    lib.sdl_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_int, ctypes.c_int, _u8p,
                               _intp, _intp, _intp]
    lib.sdl_decode.restype = ctypes.c_int
    lib.sdl_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, _intp,
        ctypes.c_int]
    lib.sdl_decode_batch.restype = ctypes.c_int
    lib.sdl_resize_batch.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _u8p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.sdl_resize_batch.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, unavailable_reason
    with _lib_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        from sparkdl_tpu_torch.core import cuda_build

        try:
            _lib = _bind(cuda_build.library(LIBRARY))
        except (RuntimeError, OSError) as e:
            lines = str(e).strip().splitlines() or [type(e).__name__]
            # the compiler's first error names the missing header
            unavailable_reason = next(
                (ln for ln in lines if "error" in ln), lines[0])[:300]
        return _lib


def available() -> bool:
    """True when the library is built (building it now if needed)."""
    return _load() is not None


def status() -> Optional[str]:
    """``"loaded"``, or why the library is unavailable, or None while
    nothing in this process has asked for it (this asks for nothing)."""
    with _lib_lock:
        if not _load_attempted:
            return None
        return "loaded" if _lib is not None else unavailable_reason


def decode(data: bytes, target_size: Optional[Tuple[int, int]] = None
           ) -> Optional[np.ndarray]:
    """Decode (and optionally bilinear-resize) JPEG/PNG bytes to HWC
    uint8, keeping the source's channels; None when undecodable or the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    if lib.sdl_probe(data, len(data), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c)) != 0:
        return None
    th, tw = target_size if target_size is not None else (h.value, w.value)
    out = np.empty((th, tw, max(c.value, 1)), dtype=np.uint8)
    rc = lib.sdl_decode(data, len(data), th, tw,
                        out.ctypes.data_as(_u8p), ctypes.byref(h),
                        ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    return out[:, :, :c.value] if out.shape[2] != c.value else out


def decode_batch(blobs: Sequence[bytes], target_size: Tuple[int, int],
                 channels: int = 3, num_threads: int = 0
                 ) -> Optional[np.ndarray]:
    """Decode many blobs into one NHWC uint8 array (threaded in C++);
    None when the library is unavailable or any blob fails."""
    res = decode_batch_status(blobs, target_size, channels, num_threads)
    if res is None:
        return None
    out, ok = res
    return out if ok.all() else None


def resize_batch(batch: np.ndarray, target_size: Tuple[int, int],
                 num_threads: int = 0) -> Optional[np.ndarray]:
    """Threaded bilinear resize of an NHWC uint8 batch (8.8 fixed-point
    weights shared per axis, the GIL released); None when the library is
    unavailable or the batch is not NHWC uint8."""
    lib = _load()
    if lib is None or batch.ndim != 4 or batch.dtype != np.uint8:
        return None
    batch = np.ascontiguousarray(batch)
    n, sh, sw, c = batch.shape
    th, tw = target_size
    out = np.empty((n, th, tw, c), dtype=np.uint8)
    rc = lib.sdl_resize_batch(batch.ctypes.data_as(_u8p), n, sh, sw, c,
                              out.ctypes.data_as(_u8p), th, tw, num_threads)
    return out if rc == 0 else None


def decode_batch_status(blobs: Sequence[bytes], target_size: Tuple[int, int],
                        channels: int = 3, num_threads: int = 0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded batch decode, forced to ``channels`` = 3 (RGB), with a
    success flag per blob: ``(nhwc_uint8, ok_mask)``, where rows with
    ``ok_mask`` False are zeros and the caller decodes them another way;
    None when the library is unavailable or ``blobs`` is empty. The C
    call runs outside the GIL, so partition threads decode in
    parallel."""
    lib = _load()
    if lib is None or not blobs:
        return None
    if channels != 3:
        raise ValueError(f"the native batch decoder forces RGB; got "
                         f"channels={channels}")
    n = len(blobs)
    th, tw = target_size
    ptrs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    out = np.empty((n, th, tw, 3), dtype=np.uint8)
    status = (ctypes.c_int * n)()
    lib.sdl_decode_batch(ptrs, lens, n, th, tw, out.ctypes.data_as(_u8p),
                         status, num_threads)
    ok = np.frombuffer(status, dtype=np.int32) == 0
    return out, ok.copy()
