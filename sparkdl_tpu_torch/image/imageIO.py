"""Image struct schema + codecs — the data contract of the featurize path.

A port of the parts of ``sparkdl_tpu.image.imageIO`` that the featurize
path uses. The struct keeps Spark's ``ImageSchema`` fields ``(origin,
height, width, nChannels, mode, data)`` with OpenCV mode codes. Where the
JAX package stores an image column as an Arrow struct array, the port
stores it as a struct of plain arrays (:class:`ImageColumn`): the
per-row metadata as int32 arrays and, when the column is uniform, the
pixels as ONE contiguous ``(N, H, W, C)`` block — what
``arrowImageBatch`` reads out of the Arrow binary buffer, without
needing pyarrow.

Decoding takes, in order: the multi-process decode pool when
``EngineConfig.decode_workers > 0`` (``core/decode_pool.py``), the
native libjpeg/libpng loader (``native/loader.py``, built at first use)
and Pillow, imported lazily inside the decoders where the loader cannot
be built or rejects a blob. Fault injection (``decode_error``) and the
``decode_degraded`` accounting happen in the submitting process on every
path, so the pool on and off give the same rows and the same events.
This module imports no torch: the decode pool's worker processes import
it.
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.core import health, profiling, resilience


def _injected_decode_error(**ctx) -> bool:
    """The ``decode_error`` behavioral point, recorded in the health
    monitor (one DECODE_DEGRADED per degraded row, so a run's report
    shows how many rows the data plane dropped to null)."""
    if resilience.should_fire("decode_error", **ctx):
        health.record(health.DECODE_DEGRADED, injected=True)
        return True
    return False

imageFields: List[str] = ["origin", "height", "width", "nChannels", "mode",
                          "data"]

ImageType = namedtuple("ImageType", ["name", "ocvType", "nChannels", "dtype"])

# OpenCV type codes, as used by Spark's ImageSchema (uint8) and extended by
# the reference to float32 images.
SUPPORTED_OCV_TYPES = (
    ImageType("CV_8UC1", 0, 1, "uint8"),
    ImageType("CV_32FC1", 5, 1, "float32"),
    ImageType("CV_8UC3", 16, 3, "uint8"),
    ImageType("CV_32FC3", 21, 3, "float32"),
    ImageType("CV_8UC4", 24, 4, "uint8"),
    ImageType("CV_32FC4", 29, 4, "float32"),
)

_OCV_BY_NAME = {t.name: t for t in SUPPORTED_OCV_TYPES}
_OCV_BY_CODE = {t.ocvType: t for t in SUPPORTED_OCV_TYPES}


def imageTypeByName(name: str) -> ImageType:
    try:
        return _OCV_BY_NAME[name]
    except KeyError:
        raise ValueError(f"Unsupported image mode name {name!r}; "
                         f"supported: {sorted(_OCV_BY_NAME)}") from None


def imageTypeByCode(code: int) -> ImageType:
    try:
        return _OCV_BY_CODE[int(code)]
    except KeyError:
        raise ValueError(f"Unsupported image mode code {code}; "
                         f"supported: {sorted(_OCV_BY_CODE)}") from None


def imageTypeForArray(array: np.ndarray) -> ImageType:
    if array.ndim != 3:
        raise ValueError(
            f"Image array must be HWC (3-D), got shape {array.shape}")
    channels = array.shape[2]
    if array.dtype == np.uint8:
        kind = "CV_8UC"
    elif array.dtype == np.float32:
        kind = "CV_32FC"
    else:
        raise ValueError(f"Unsupported image array dtype {array.dtype}; "
                         "use uint8 or float32")
    return imageTypeByName(f"{kind}{channels}")


# ---------------------------------------------------------------------------
# numpy <-> struct codecs
# ---------------------------------------------------------------------------

def imageArrayToStruct(imgArray: np.ndarray, origin: str = "") -> dict:
    """Encode an HWC numpy array as an image-struct dict."""
    if imgArray.ndim == 2:
        imgArray = imgArray[:, :, None]
    imgArray = np.ascontiguousarray(imgArray)
    imType = imageTypeForArray(imgArray)
    height, width, nChannels = imgArray.shape
    return {
        "origin": origin,
        "height": int(height),
        "width": int(width),
        "nChannels": int(nChannels),
        "mode": imType.ocvType,
        "data": imgArray.tobytes(),
    }


def imageStructToArray(imageRow) -> np.ndarray:
    """Decode an image-struct dict to an HWC numpy array."""
    imType = imageTypeByCode(imageRow["mode"])
    shape = (imageRow["height"], imageRow["width"], imageRow["nChannels"])
    return np.frombuffer(imageRow["data"], dtype=imType.dtype).reshape(shape)


class ImageColumn:
    """An image-struct column as a struct of arrays.

    ``origin`` is a list of str; ``height``/``width``/``nChannels``/``mode``
    are int32 arrays; ``valid`` is a bool array (False = null row). The
    pixels are either ``block``, one contiguous ``(N_valid, H, W, C)``
    array holding the valid rows in order (a uniform column), or
    ``data``, one ``bytes`` payload per row (None for null rows).
    """

    def __init__(self, origin: Sequence[str], height, width, nChannels, mode,
                 valid, block: Optional[np.ndarray] = None,
                 data: Optional[List[Optional[bytes]]] = None) -> None:
        if (block is None) == (data is None):
            raise ValueError("an ImageColumn holds exactly one of block/data")
        self.origin = list(origin)
        self.height = np.asarray(height, dtype=np.int32)
        self.width = np.asarray(width, dtype=np.int32)
        self.nChannels = np.asarray(nChannels, dtype=np.int32)
        self.mode = np.asarray(mode, dtype=np.int32)
        self.valid = np.asarray(valid, dtype=bool)
        self.block = block
        self.data = data

    def __len__(self) -> int:
        return len(self.origin)

    def _payloads(self) -> List[Optional[bytes]]:
        if self.data is not None:
            return self.data
        out: List[Optional[bytes]] = [None] * len(self)
        for j, i in enumerate(np.nonzero(self.valid)[0]):
            out[i] = self.block[j].tobytes()
        return out

    def to_pylist(self) -> List[Optional[dict]]:
        payloads = self._payloads()
        return [{"origin": self.origin[i], "height": int(self.height[i]),
                 "width": int(self.width[i]),
                 "nChannels": int(self.nChannels[i]),
                 "mode": int(self.mode[i]), "data": payloads[i]}
                if self.valid[i] else None
                for i in range(len(self))]

    def take(self, indices) -> "ImageColumn":
        idx = np.asarray(indices, dtype=np.int64)
        meta = dict(origin=[self.origin[i] for i in idx],
                    height=self.height[idx], width=self.width[idx],
                    nChannels=self.nChannels[idx], mode=self.mode[idx],
                    valid=self.valid[idx])
        if self.data is not None:
            return ImageColumn(data=[self.data[i] for i in idx], **meta)
        # block row of each valid source row = its rank among valid rows
        rank = np.cumsum(self.valid) - 1
        keep = idx[self.valid[idx]]
        return ImageColumn(block=self.block[rank[keep]], **meta)

    def slice(self, start: int, stop: int) -> "ImageColumn":
        return self.take(np.arange(start, min(stop, len(self))))


def uniformImageBatch(col: ImageColumn
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(batch, valid_indices)`` for a uniform column, else None.

    The port's stand-in for ``arrowImageBatch``: ``batch`` is the column's
    contiguous ``(N_valid, H, W, C)`` block itself (no copy, no per-row
    Python) and ``valid_indices`` indexes its non-null rows. A column of
    per-row payloads (built from struct dicts, e.g. by a row-wise
    ``withColumn``) is uniform on the reference's terms too: every valid
    row of one height, width, channel count and known mode, each payload
    exactly one such image; its payloads are then joined into one block.
    Other columns return None and callers take the per-row path.
    """
    if not isinstance(col, ImageColumn):
        return None
    valid_idx = np.nonzero(col.valid)[0]
    if valid_idx.size == 0:
        return None
    if col.block is not None:
        return col.block, valid_idx
    meta = [getattr(col, f)[valid_idx]
            for f in ("height", "width", "nChannels", "mode")]
    if any(m.min() != m.max() for m in meta):
        return None
    h, w, c, mode = (int(m[0]) for m in meta)
    try:
        dtype = np.dtype(imageTypeByCode(mode).dtype)
    except ValueError:
        return None
    payloads = [col.data[i] for i in valid_idx]
    row_bytes = h * w * c * dtype.itemsize
    if any(p is None or len(p) != row_bytes for p in payloads):
        return None  # metadata lied: the per-row path validates
    block = np.frombuffer(b"".join(payloads), dtype=dtype)
    return block.reshape(len(valid_idx), h, w, c), valid_idx


def imageStructsToBatchArray(structs: Sequence[dict],
                             target_size: Optional[Tuple[int, int]] = None,
                             dtype: Optional[str] = "float32",
                             channels: int = 3) -> np.ndarray:
    """Decode many image structs to one NHWC batch, resizing if needed.

    ``dtype=None`` keeps the source dtype when uniform (uint8 images stage
    as uint8; the device casts) and promotes to float32 when mixed."""
    batch, _kept, _dropped = _stage_structs(structs, target_size, dtype,
                                            channels, tolerant=False)
    return batch


def imageStructsToBatchArrayTolerant(
        structs: Sequence[dict],
        target_size: Optional[Tuple[int, int]] = None,
        dtype: Optional[str] = "float32",
        channels: int = 3) -> Tuple[np.ndarray, List[int], int]:
    """Like :func:`imageStructsToBatchArray`, but malformed rows are
    DROPPED instead of aborting the partition. Returns ``(batch,
    kept_indices, n_dropped)``, ``kept_indices`` indexing ``structs``."""
    return _stage_structs(structs, target_size, dtype, channels,
                          tolerant=True)


def _stage_structs(structs, target_size, dtype, channels, tolerant: bool
                   ) -> Tuple[np.ndarray, List[int], int]:
    arrays: List[np.ndarray] = []
    kept: List[int] = []
    dropped = 0
    for i, s in enumerate(structs):
        try:
            if tolerant and resilience.should_fire("decode_error"):
                raise ValueError("injected decode_error")
            arr = imageStructToArray(s)
            if (target_size is not None
                    and arr.shape[:2] != tuple(target_size)):
                arr = resizeImageArray(arr, target_size)
            arrays.append(arr if dtype is None
                          else np.asarray(arr, dtype=dtype))
            kept.append(i)
        except Exception:  # noqa: BLE001 - per-row degradation
            if not tolerant:
                raise
            dropped += 1
    if dropped:
        health.record(health.DECODE_DEGRADED, n=dropped, stage="structs")
    if arrays:
        if dtype is None and len({a.dtype for a in arrays}) > 1:
            arrays = [np.asarray(a, dtype="float32") for a in arrays]
        return np.stack(arrays), kept, dropped
    empty_dtype = dtype or "uint8"
    if target_size is not None:
        empty = np.zeros((0, target_size[0], target_size[1], channels),
                         dtype=empty_dtype)
    else:
        empty = np.zeros((0,), dtype=empty_dtype)
    return empty, kept, dropped


def imageArraysToStructColumn(arrays: Sequence[Optional[np.ndarray]],
                              origins: Sequence[str]) -> ImageColumn:
    """Image-struct column from decoded HWC arrays (None = null row).

    A uniform batch (same HWC shape and dtype) packs into ONE contiguous
    block — a single ``np.stack``; :func:`uniformImageBatch` hands it to
    the device path without another copy. Ragged batches keep one bytes
    payload per row."""
    n = len(arrays)
    valid = np.array([a is not None for a in arrays], dtype=bool)
    meta = np.zeros((4, n), dtype=np.int32)
    for i, a in enumerate(arrays):
        if a is not None:
            a = a[:, :, None] if a.ndim == 2 else a
            meta[:, i] = (*a.shape, imageTypeForArray(a).ocvType)
    origins = ["" if o is None else o for o in origins]
    present = [a for a in arrays if a is not None]
    uniform = bool(present) and all(
        a.ndim == 3 and a.shape == present[0].shape
        and a.dtype == present[0].dtype for a in present)
    if uniform:
        block = np.ascontiguousarray(np.stack(present))
        return ImageColumn(origins, *meta, valid, block=block)
    data = [imageArrayToStruct(a)["data"] if a is not None else None
            for a in arrays]
    return ImageColumn(origins, *meta, valid, data=data)


def imageStructsToColumn(structs: Sequence[Optional[dict]]) -> ImageColumn:
    """Image-struct column from per-row struct dicts (None = null row),
    payloads kept as given: a malformed row stays in the column and
    degrades to a null output where it is staged."""
    def field(name, default):
        return [s[name] if s is not None else default for s in structs]

    return ImageColumn(field("origin", ""), field("height", 0),
                       field("width", 0), field("nChannels", 0),
                       field("mode", 0), [s is not None for s in structs],
                       data=field("data", None))


# ---------------------------------------------------------------------------
# Decode / resize (native fast path, Pillow fallback)
# ---------------------------------------------------------------------------

def _pil_decode(data: bytes, target_size=None) -> Optional[np.ndarray]:
    from io import BytesIO

    from PIL import Image

    try:
        img = Image.open(BytesIO(data))
        if img.mode not in ("L", "RGB", "RGBA"):
            img = img.convert("RGB")
        if target_size is not None:
            # Pillow's size is (W, H); target_size is (H, W) like the spec
            img = img.resize((target_size[1], target_size[0]), Image.BILINEAR)
        arr = np.asarray(img)
    except Exception:  # noqa: BLE001 - a corrupt image becomes a null row
        return None
    return arr[:, :, None] if arr.ndim == 2 else arr


def decodeImageBytes(data: bytes, target_size=None,
                     channels: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode compressed image bytes → HWC uint8 array (None on failure).

    ``channels=None`` keeps the source's channel count (grayscale stays
    1-channel, like Spark's ImageSchema reader); 3 forces RGB, the
    model-staging contract, so the per-row path matches the batch
    decoder's output for the same input."""
    from sparkdl_tpu_torch.native import loader as native_loader

    if channels is not None:
        if target_size is not None:
            # the batch decoder checks decode_error itself: checking here
            # too would take two occurrences of the fault per decode
            return decodeImageBytesBatch([data], target_size,
                                         channels=channels)[0]
        if _injected_decode_error():
            return None
        if native_loader.available():
            arr = native_loader.decode(data, target_size=None)
            if arr is not None:
                return forceChannels(arr, channels)
        out = _pil_decode_channels(data, None, channels)
        if out is None:
            health.record(health.DECODE_DEGRADED, stage="bytes")
        return out
    if _injected_decode_error():
        return None
    if native_loader.available():
        arr = native_loader.decode(data, target_size=target_size)
        if arr is not None:
            return arr
    out = _pil_decode(data, target_size=target_size)
    if out is None:
        health.record(health.DECODE_DEGRADED, stage="bytes")
    return out


def stripFileScheme(uri: str) -> str:
    """Normalize 'file://<path>' / 'file:<path>' URIs to a plain path."""
    if uri.startswith("file://"):
        return uri[7:]
    if uri.startswith("file:"):
        return uri[5:]
    return uri


def _read_blobs(uris: Sequence[Optional[str]]) -> List[Optional[bytes]]:
    """Each URI's file bytes; None for a null URI or a file that cannot
    be read."""
    blobs: List[Optional[bytes]] = []
    for uri in uris:
        if uri is None:
            blobs.append(None)
            continue
        try:
            with open(stripFileScheme(uri), "rb") as f:
                blobs.append(f.read())
        except OSError:
            blobs.append(None)
    return blobs


def decodeImageFile(path: str, target_size=None,
                    channels: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode an image file URI → HWC uint8 array (None on failure)."""
    data = _read_blobs([path])[0]
    if data is None:
        return None
    return decodeImageBytes(data, target_size=target_size, channels=channels)


def decodeImageBytesBatch(blobs: Sequence[Optional[bytes]],
                          target_size: Tuple[int, int],
                          channels: int = 3) -> List[Optional[np.ndarray]]:
    """Decode a partition's worth of compressed blobs at once.

    Paths, in order: the decode pool when ``EngineConfig.decode_workers
    > 0`` (the list fans out to worker processes and comes back through
    shared memory, in order and pixel-identical to the inline path);
    else ONE call into the threaded native ``sdl_decode_batch`` (the GIL
    released for the whole batch), with Pillow for the blobs it rejects
    (or for all, without the library). One HWC uint8 array (or None) per
    blob, in order. Fault injection and health accounting happen here,
    in the submitting process, whatever the path."""
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    valid = [i for i, b in enumerate(blobs)
             if b and not _injected_decode_error()]
    if not valid:
        return out
    picked = [blobs[i] for i in valid]
    pool = _maybe_decode_pool(len(picked))
    if pool is not None:
        decoded = pool.decode(picked, target_size=target_size,
                              channels=channels)
    else:
        decoded = _decodeValidBlobs(picked, target_size, channels)
    for j, i in enumerate(valid):
        out[i] = decoded[j]
    undecodable = sum(1 for i in valid if out[i] is None)
    if undecodable:
        # corrupt blobs (the injected ones were counted as they fired)
        health.record(health.DECODE_DEGRADED, n=undecodable, stage="bytes")
    return out


def _maybe_decode_pool(n_blobs: int):
    """The process-wide decode pool, or None when it is off or a call
    is not worth a round trip (one blob: the per-row path stays
    inline)."""
    if n_blobs < 2:
        return None
    from sparkdl_tpu_torch.core import decode_pool

    return decode_pool.maybe_pool()


def _decodeValidBlobs(blobs: Sequence[bytes], target_size: Tuple[int, int],
                      channels: int) -> List[Optional[np.ndarray]]:
    """Decode non-null blobs to fixed-geometry HWC uint8, with no fault
    injection and no health accounting (the caller owns both). The
    inline path and the decode-pool workers share it, so their pixels
    cannot drift apart.

    The native batch decoder forces RGB, so it serves ``channels=3``
    only; Pillow decodes the rest, and the blobs it rejects, reusing one
    scratch buffer."""
    from sparkdl_tpu_torch.native import loader as native_loader

    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    if channels == 3:
        res = native_loader.decode_batch_status(list(blobs), target_size)
        if res is not None:
            batch, ok = res
            for i in np.nonzero(ok)[0]:
                out[i] = batch[i]
    remaining = [i for i in range(len(blobs)) if out[i] is None]
    if not remaining:
        return out
    from io import BytesIO

    from PIL import Image

    mode = _pil_mode(channels)
    scratch = BytesIO()
    for i in remaining:
        scratch.seek(0)
        scratch.truncate()
        scratch.write(blobs[i])
        scratch.seek(0)
        try:
            img = Image.open(scratch).convert(mode)
            if target_size is not None:
                img = img.resize((target_size[1], target_size[0]),
                                 Image.BILINEAR)
            arr = np.asarray(img)
        except Exception:  # noqa: BLE001 - per-blob degradation to None
            continue
        out[i] = arr[:, :, None] if arr.ndim == 2 else arr
    return out


def decodePoolChunk(blobs: Sequence[Optional[bytes]],
                    target_size: Optional[Tuple[int, int]] = None,
                    channels: Optional[int] = None
                    ) -> List[Optional[np.ndarray]]:
    """One decode-pool chunk, decoded in the worker with the inline
    path's semantics: with a fixed geometry the whole chunk goes through
    :func:`_decodeValidBlobs` (one native threaded call per chunk).
    Errors the inline path would raise (an unsupported channel count)
    propagate: the pool ships them back and raises them in the
    submitting process."""
    present = [i for i, b in enumerate(blobs) if b]
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    if target_size is not None and channels is not None:
        decoded = _decodeValidBlobs([blobs[i] for i in present],
                                    target_size, channels)
        for j, i in enumerate(present):
            out[i] = decoded[j]
        return out
    for i in present:
        out[i] = decodePoolBlob(blobs[i], target_size=target_size,
                                channels=channels)
    return out


def decodePoolBlob(blob: Optional[bytes],
                   target_size: Optional[Tuple[int, int]] = None,
                   channels: Optional[int] = None) -> Optional[np.ndarray]:
    """One blob decoded with the inline path's pixels but no fault
    injection and no health record: the decode-pool worker's entry."""
    if not blob:
        return None
    if target_size is not None and channels is not None:
        return _decodeValidBlobs([blob], target_size, channels)[0]
    from sparkdl_tpu_torch.native import loader as native_loader

    if native_loader.available():
        arr = native_loader.decode(blob, target_size=target_size)
        if arr is not None:
            return forceChannels(arr, channels) if channels is not None \
                else arr
    if channels is not None:
        return _pil_decode_channels(blob, target_size, channels)
    return _pil_decode(blob, target_size=target_size)


_PIL_MODE_BY_CHANNELS = {1: "L", 3: "RGB", 4: "RGBA"}


def _pil_mode(channels: int) -> str:
    try:
        return _PIL_MODE_BY_CHANNELS[channels]
    except KeyError:
        raise ValueError(
            f"Unsupported channel count {channels}; "
            f"supported: {sorted(_PIL_MODE_BY_CHANNELS)}") from None


def forceChannels(arr: np.ndarray, channels: int) -> np.ndarray:
    """Coerce an HWC uint8 array to a channel count with Pillow's
    ``convert`` semantics (L→RGB replicates, RGBA→RGB drops alpha,
    RGB→L is ITU-R 601 luma)."""
    have = arr.shape[2]
    if have == channels:
        return arr
    if channels == 3:
        if have == 1:
            return np.repeat(arr, 3, axis=2)
        if have == 4:
            return np.ascontiguousarray(arr[:, :, :3])
    if channels == 1 and have in (3, 4):
        luma = (arr[:, :, 0] * 0.299 + arr[:, :, 1] * 0.587
                + arr[:, :, 2] * 0.114)
        return luma.astype(np.uint8)[:, :, None]
    if channels == 4 and have == 3:
        alpha = np.full(arr.shape[:2] + (1,), 255, dtype=np.uint8)
        return np.concatenate([arr, alpha], axis=2)
    raise ValueError(f"Cannot coerce {have}-channel image to {channels}")


def _pil_decode_channels(data: bytes, target_size, channels: int
                         ) -> Optional[np.ndarray]:
    """Pillow decode forced to 1, 3 or 4 channels (others raise)."""
    from io import BytesIO

    from PIL import Image

    mode = _pil_mode(channels)
    try:
        img = Image.open(BytesIO(data)).convert(mode)
        if target_size is not None:
            img = img.resize((target_size[1], target_size[0]), Image.BILINEAR)
        arr = np.asarray(img)
    except Exception:  # noqa: BLE001 - a corrupt image becomes a null row
        return None
    return arr[:, :, None] if arr.ndim == 2 else arr


def decodeImageFilesBatch(uris: Sequence[Optional[str]],
                          target_size: Tuple[int, int],
                          channels: int = 3) -> List[Optional[np.ndarray]]:
    """Read and batch-decode image files; one HWC uint8 (or None) per
    URI."""
    return decodeImageBytesBatch(_read_blobs(uris), target_size,
                                 channels=channels)


def resizeBatchArray(batch: np.ndarray, target_size: Tuple[int, int]
                     ) -> np.ndarray:
    """Vectorized bilinear resize of an NHWC batch (numpy, any dtype).

    Pixel-centre sampling WITHOUT antialiasing, the convention of the
    native ``sdl_resize_batch`` and of the card's ``preproc_resize``
    (they agree to uint8 rounding), not Pillow's. The host fallback when
    the native library is unavailable or the dtype is not uint8."""
    n, sh, sw, c = batch.shape
    th, tw = target_size
    if (sh, sw) == (th, tw):
        return batch
    fy = np.clip((np.arange(th) + 0.5) * (sh / th) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(tw) + 0.5) * (sw / tw) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x0 = fx.astype(np.int64)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0).astype(np.float32)[None, :, None, None]
    wx = (fx - x0).astype(np.float32)[None, None, :, None]
    b = batch.astype(np.float32, copy=False)
    top = b[:, y0][:, :, x0] * (1 - wx) + b[:, y0][:, :, x1] * wx
    bot = b[:, y1][:, :, x0] * (1 - wx) + b[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    if batch.dtype == np.uint8:
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)
    return out.astype(batch.dtype)


def resizeImageArray(arr: np.ndarray, target_size: Tuple[int, int]
                     ) -> np.ndarray:
    """Bilinear-resize an HWC array to (H, W) on the host with Pillow."""
    from PIL import Image

    th, tw = target_size
    if arr.shape[:2] == (th, tw):
        return arr
    in_dtype = arr.dtype
    if in_dtype == np.uint8:
        img = Image.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr)
        out = np.asarray(img.resize((tw, th), Image.BILINEAR))
        return out[:, :, None] if out.ndim == 2 else out
    planes = [np.asarray(Image.fromarray(arr[:, :, c], mode="F")
                         .resize((tw, th), Image.BILINEAR))
              for c in range(arr.shape[2])]
    return np.stack(planes, axis=-1).astype(in_dtype)


# ---------------------------------------------------------------------------
# DataFrame readers (parity: readImagesWithCustomFn / readImages)
# ---------------------------------------------------------------------------

_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".bmp")


def listImageFiles(path: str) -> List[str]:
    path = stripFileScheme(path)
    if os.path.isfile(path):
        return [path]
    found = []
    for root, _dirs, files in os.walk(path):
        for fname in sorted(files):
            if fname.lower().endswith(_IMAGE_EXTENSIONS):
                found.append(os.path.join(root, fname))
    return sorted(found)


def _decodeBlobsDefault(blobs: Sequence[Optional[bytes]]
                        ) -> List[Optional[np.ndarray]]:
    """The default decoder (:func:`decodeImageBytes`: no target size,
    the source's channels) over a partition's blobs: fanned out to the
    decode pool when it is on, else the inline loop. Fault injection and
    the per-row ``decode_degraded`` events stay in this process on both
    paths, in row order."""
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    present = [i for i, b in enumerate(blobs) if b is not None]
    pool = _maybe_decode_pool(len(present))
    if pool is None:
        for i in present:
            out[i] = decodeImageBytes(blobs[i])
        return out
    valid = [i for i in present if not _injected_decode_error()]
    decoded = pool.decode([blobs[i] for i in valid])
    for j, i in enumerate(valid):
        out[i] = decoded[j]
        if decoded[j] is None:
            # the event decodeImageBytes records for the row
            health.record(health.DECODE_DEGRADED, stage="bytes")
    return out


def _readImagesDecodePartition(batch) -> ImageColumn:
    """The default ``readImages`` decoder's partition op: read every
    file, batch-decode (pool-aware), wrap as an image-struct column (one
    contiguous block when the partition decodes uniform)."""
    uris = list(batch.column("filePath"))
    with profiling.annotate("sparkdl.decode", rows=len(uris)):
        arrays = _decodeBlobsDefault(_read_blobs(uris))
    return imageArraysToStructColumn(arrays, uris)


def readImagesWithCustomFn(path: str,
                           decode_f: Callable[[bytes], Optional[np.ndarray]],
                           numPartition: Optional[int] = None):
    """Read images under ``path`` with a custom decode fn → DataFrame.

    Returns a DataFrame with ``filePath`` and an ``image`` struct column;
    undecodable files yield null image structs, as the reference did.
    Decoding runs lazily, one whole partition at a time: the default
    decoder (:func:`decodeImageBytes`) as one batch op that the decode
    pool can fan out, a custom ``decode_f`` row by row."""
    from sparkdl_tpu_torch.engine.dataframe import DataFrame

    uris = ["file:" + f for f in listImageFiles(path)]
    paths_df = DataFrame.fromColumns({"filePath": uris},
                                     numPartitions=numPartition)
    if decode_f is decodeImageBytes:
        return paths_df.withColumnBatch("image", _readImagesDecodePartition)

    def decode_partition(batch) -> ImageColumn:
        uris = list(batch.column("filePath"))
        arrays: List[Optional[np.ndarray]] = []
        with profiling.annotate("sparkdl.decode", rows=len(uris)):
            for raw in _read_blobs(uris):
                arr = None if raw is None else decode_f(raw)
                arrays.append(None if arr is None else np.asarray(arr))
        return imageArraysToStructColumn(arrays, uris)

    return paths_df.withColumnBatch("image", decode_partition)


def readImages(path: str, numPartition: Optional[int] = None):
    """Read images with the default decoder (native loader, Pillow where
    it cannot serve)."""
    return readImagesWithCustomFn(path, decodeImageBytes, numPartition)
