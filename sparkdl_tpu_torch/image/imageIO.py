"""Image struct schema + codecs — the data contract of the featurize path.

A port of the parts of ``sparkdl_tpu.image.imageIO`` that the featurize
path uses. The struct keeps Spark's ``ImageSchema`` fields ``(origin,
height, width, nChannels, mode, data)`` with OpenCV mode codes. Where the
JAX package stores an image column as an Arrow struct array, the port
stores it as a struct of plain arrays (:class:`ImageColumn`): the
per-row metadata as int32 arrays and, when the column is uniform, the
pixels as ONE contiguous ``(N, H, W, C)`` block — what
``arrowImageBatch`` reads out of the Arrow binary buffer, without
needing pyarrow. Pillow is imported lazily, only inside the decoders.
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.core import health, profiling

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
    Python) and ``valid_indices`` indexes its non-null rows. Ragged
    columns return None and callers take the per-row path.
    """
    if not isinstance(col, ImageColumn) or col.block is None:
        return None
    valid_idx = np.nonzero(col.valid)[0]
    if valid_idx.size == 0:
        return None
    return col.block, valid_idx


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
            arr = imageStructToArray(s)
            if (target_size is not None
                    and arr.shape[:2] != tuple(target_size)):
                arr = resizeImageArray(arr, target_size)
            arrays.append(arr if dtype is None
                          else np.asarray(arr, dtype=dtype))
            kept.append(i)
        except (ValueError, KeyError, TypeError):
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
# Decode / resize (Pillow, imported lazily)
# ---------------------------------------------------------------------------

def _pil_decode(data: bytes) -> Optional[np.ndarray]:
    from io import BytesIO

    from PIL import Image

    try:
        img = Image.open(BytesIO(data))
        if img.mode not in ("L", "RGB", "RGBA"):
            img = img.convert("RGB")
        return np.asarray(img)
    except Exception:  # noqa: BLE001 - a corrupt image becomes a null row
        return None


def decodeImageBytes(data: bytes) -> Optional[np.ndarray]:
    """Decode compressed image bytes → HWC uint8 array (None on failure).
    The source's channel count is kept (grayscale stays 1-channel)."""
    arr = _pil_decode(data)
    if arr is None:
        health.record(health.DECODE_DEGRADED, stage="bytes")
    elif arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def stripFileScheme(uri: str) -> str:
    """Normalize 'file://<path>' / 'file:<path>' URIs to a plain path."""
    if uri.startswith("file://"):
        return uri[7:]
    if uri.startswith("file:"):
        return uri[5:]
    return uri


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


def readImagesWithCustomFn(path: str,
                           decode_f: Callable[[bytes], Optional[np.ndarray]],
                           numPartition: Optional[int] = None):
    """Read images under ``path`` with a custom decode fn → DataFrame.

    Returns a DataFrame with ``filePath`` and an ``image`` struct column;
    undecodable files yield null image structs, as the reference did.
    Decoding runs lazily, one whole partition at a time."""
    from sparkdl_tpu_torch.engine.dataframe import DataFrame

    uris = ["file:" + f for f in listImageFiles(path)]
    paths_df = DataFrame.fromColumns({"filePath": uris},
                                     numPartitions=numPartition)

    def decode_partition(batch) -> ImageColumn:
        uris = batch.column("filePath")
        arrays: List[Optional[np.ndarray]] = []
        with profiling.annotate("sparkdl.decode", rows=len(uris)):
            for uri in uris:
                try:
                    with open(stripFileScheme(uri), "rb") as f:
                        raw = f.read()
                except OSError:
                    arrays.append(None)
                    continue
                arr = decode_f(raw)
                arrays.append(None if arr is None else np.asarray(arr))
        return imageArraysToStructColumn(arrays, list(uris))

    return paths_df.withColumnBatch("image", decode_partition)


def readImages(path: str, numPartition: Optional[int] = None):
    """Read images with the default decoder (Pillow)."""
    return readImagesWithCustomFn(path, decodeImageBytes, numPartition)
