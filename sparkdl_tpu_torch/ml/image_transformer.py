"""TorchImageTransformer — a model applied to an image column.

A port of ``sparkdl_tpu.ml.image_transformer.TPUImageTransformer`` (the
reference's ``TFImageTransformer``):

    host: image column → one contiguous NHWC uint8 batch
    device: cast → resize (preproc_resize) → preprocess → model → flatten

run per partition through ``DataFrame.withColumnBatch``, with every
device call going through ``core.executor.execute`` (where concurrent
partitions of one model coalesce), in the lane of the ``priority``
param.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.core import executor as device_executor
from sparkdl_tpu_torch.core import profiling
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.converters import TypeConverters
from sparkdl_tpu_torch.param.shared_params import (
    HasBatchSize, HasInputCol, HasModelFunction, HasOutputCol,
    HasOutputMode, HasPriority,
)

logger = logging.getLogger(__name__)

# Chunk-staging depth of the async input pipeline inside apply_batch
# (core/pipeline.py); 0 falls back to inline serial staging.
_PREFETCH_DEPTH = 2


class TorchImageTransformer(Transformer, HasInputCol, HasOutputCol,
                            HasModelFunction, HasOutputMode, HasBatchSize,
                            HasPriority):
    """Apply a ModelFunction to an image-struct column.

    ``outputMode="vector"`` flattens model output per row into a float
    vector column; ``outputMode="image"`` re-wraps 3-D HWC output as image
    structs.
    """

    inputSize = Param(
        "TorchImageTransformer", "inputSize",
        "(H, W) images are resized to before the model; None uses the "
        "model input spec's spatial dims",
        typeConverter=TypeConverters.identity)

    @keyword_only
    def __init__(self, *, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFunction=None,
                 outputMode: str = "vector",
                 batchSize: int = 64,
                 inputSize: Optional[Tuple[int, int]] = None,
                 priority: Optional[str] = None) -> None:
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64, inputSize=None)
        self.setParams(**self._input_kwargs)

    @keyword_only
    def setParams(self, *, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFunction=None,
                  outputMode: str = "vector",
                  batchSize: int = 64,
                  inputSize: Optional[Tuple[int, int]] = None,
                  priority: Optional[str] = None
                  ) -> "TorchImageTransformer":
        return self._set(**self._input_kwargs)

    def setInputSize(self, value) -> "TorchImageTransformer":
        return self._set(inputSize=value)

    def getInputSize(self):
        return self.getOrDefault(self.inputSize)

    def save(self, path: str) -> None:
        """Not ported yet: the reference saves a ModelFunction-backed
        stage as a StableHLO export with the weights baked in, and the
        port has no such serialized-program artifact."""
        raise NotImplementedError(
            "TorchImageTransformer.save is not yet ported to "
            "sparkdl_tpu_torch: it needs a serialized-program artifact of "
            "its ModelFunction (the reference's StableHLO export, "
            "ml/persistence.py save_model_function)")

    # -- execution -----------------------------------------------------------

    def _target_size(self, model) -> Optional[Tuple[int, int]]:
        size = self.getOrDefault(self.inputSize)
        if size is not None:
            return tuple(size)
        return model.input_spec.spatial_size()

    def _transform(self, dataset):
        model = self.getModelFunction()
        if model is None:
            raise ValueError("modelFunction must be set")
        # decided now, not at collect: without the configured device the
        # transform fails here instead of running somewhere else later
        device_executor.resolve_device()
        input_col = self.getInputCol()
        mode = self.getOutputMode()
        batch_size = self.getBatchSize()
        target_size = self._target_size(model)
        priority = self.getPriority()  # None: EngineConfig default lane
        run = model.flattened() if mode == "vector" else model
        if input_col not in dataset.columns:
            raise KeyError(f"No such column: {input_col!r}")

        def apply_partition(batch):
            col = batch.column(input_col)
            # Uniform column → its contiguous NHWC block, no per-row work.
            fast = imageIO.uniformImageBatch(col)
            if fast is not None:
                stacked, valid_idx = fast
                valid = valid_idx.tolist()
                stacked, run_fast = _resize_uniform_batch(stacked,
                                                          target_size, run)
                with profiling.annotate("sparkdl.device_apply",
                                        rows=len(stacked)):
                    out = device_executor.execute(
                        run_fast, stacked, batch_size=batch_size,
                        prefetch=_PREFETCH_DEPTH, priority=priority)
                if mode == "vector":
                    return _vectors_with_nulls(out, valid, batch.num_rows)
                return _images_with_nulls(out, valid, batch.num_rows,
                                          [col.origin[i] for i in valid])

            # Ragged columns: per-row staging, host resize, and malformed
            # rows degrade to null cells instead of failing the partition.
            structs = (col.to_pylist() if isinstance(col, imageIO.ImageColumn)
                       else list(col))
            present = [i for i, s in enumerate(structs) if s is not None]
            with profiling.annotate("sparkdl.host_stage",
                                    rows=len(present)):
                stacked, kept, dropped = \
                    imageIO.imageStructsToBatchArrayTolerant(
                        [structs[i] for i in present],
                        target_size=target_size, dtype=None)
            if dropped:
                logger.warning(
                    "TorchImageTransformer: dropped %d undecodable image "
                    "row(s) of %d in partition (%r) — emitting null cells",
                    dropped, len(present), input_col)
            valid = [present[j] for j in kept]
            if not valid:
                return [None] * batch.num_rows
            with profiling.annotate("sparkdl.device_apply",
                                    rows=len(stacked)):
                out = device_executor.execute(run, stacked,
                                              batch_size=batch_size,
                                              prefetch=_PREFETCH_DEPTH,
                                              priority=priority)
            if mode == "vector":
                return _vectors_with_nulls(out, valid, batch.num_rows)
            return _images_with_nulls(out, valid, batch.num_rows,
                                      [structs[i]["origin"] for i in valid])

        return dataset.withColumnBatch(self.getOutputCol(), apply_partition)


def _resize_uniform_batch(stacked: np.ndarray, target_size, run):
    """Resize policy for a uniform batch; returns the (possibly resized)
    batch and the (possibly resize-composed) ModelFunction.

    Under ``EngineConfig.fused_preprocess`` (the default) the raw batch
    ships at source size and the resize runs on the card in front of the
    model (``ModelFunction.resized``, the ``preproc_resize`` kernel).
    With it off, a downscale resizes on the host (the native loader's
    threaded ``sdl_resize_batch`` for uint8, ``imageIO.resizeBatchArray``
    otherwise or without the library) and ships the smaller batch; an
    upscale ships the smaller source and still resizes on the card. All
    of these sample at pixel centres without antialiasing; they differ
    by uint8 rounding only."""
    if target_size is None or tuple(stacked.shape[1:3]) == tuple(target_size):
        return stacked, run
    target = tuple(target_size)
    if EngineConfig.fused_preprocess or (
            stacked.shape[1] * stacked.shape[2] <= target[0] * target[1]):
        return stacked, run.resized(stacked.shape[1:3], target)
    with profiling.annotate("sparkdl.host_resize", rows=len(stacked)):
        resized = None
        if stacked.dtype == np.uint8:
            from sparkdl_tpu_torch.native import loader as native_loader

            resized = native_loader.resize_batch(stacked, target)
        if resized is None:
            resized = imageIO.resizeBatchArray(stacked, target)
    return resized, run


def _vectors_with_nulls(out: np.ndarray, valid: List[int], num_rows: int):
    out = np.asarray(out, dtype=np.float32).reshape(len(valid), -1)
    if len(valid) == num_rows:
        return out
    values: list = [None] * num_rows
    for j, i in enumerate(valid):
        values[i] = out[j]
    return values


def _images_with_nulls(out: np.ndarray, valid: List[int], num_rows: int,
                       origins) -> imageIO.ImageColumn:
    out = np.asarray(out)
    if out.ndim != 4:
        raise ValueError(
            f"outputMode='image' needs NHWC model output, got shape "
            f"{out.shape}")
    arrays: list = [None] * num_rows
    names = [""] * num_rows
    for j, i in enumerate(valid):
        arr = out[j]
        arrays[i] = arr if arr.dtype in (np.uint8, np.float32) \
            else arr.astype(np.float32)
        names[i] = origins[j]
    return imageIO.imageArraysToStructColumn(arrays, names)
