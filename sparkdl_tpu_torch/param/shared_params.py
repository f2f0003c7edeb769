"""Shared param mixins used by the ported transformers.

A copy of the mixins of ``sparkdl_tpu.param.shared_params`` that the
featurize, ingest and classifier paths read; the payload of
``HasModelFunction`` is the port's
:class:`sparkdl_tpu_torch.core.model_function.ModelFunction`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from sparkdl_tpu_torch.param.base import Param, Params
from sparkdl_tpu_torch.param.converters import (
    SparkDLTypeConverters, TypeConverters,
)


class HasInputCol(Params):
    inputCol = Param(
        "HasInputCol", "inputCol", "name of the input column",
        typeConverter=SparkDLTypeConverters.toColumnName)

    def setInputCol(self, value: str) -> "HasInputCol":
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(
        "HasOutputCol", "outputCol", "name of the output column",
        typeConverter=SparkDLTypeConverters.toColumnName)

    def setOutputCol(self, value: str) -> "HasOutputCol":
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)


class HasLabelCol(Params):
    labelCol = Param(
        "HasLabelCol", "labelCol",
        "name of the label column (one-hot or class-index encoded)",
        typeConverter=SparkDLTypeConverters.toColumnName)

    def setLabelCol(self, value: str) -> "HasLabelCol":
        return self._set(labelCol=value)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)


class HasOutputMode(Params):
    outputMode = Param(
        "HasOutputMode", "outputMode",
        "how model output is written: 'vector' (flattened 1-D) or 'image' "
        "(re-encoded image struct)",
        typeConverter=SparkDLTypeConverters.toOutputMode)

    def setOutputMode(self, value: str) -> "HasOutputMode":
        return self._set(outputMode=value)

    def getOutputMode(self) -> str:
        return self.getOrDefault(self.outputMode)


class HasBatchSize(Params):
    batchSize = Param(
        "HasBatchSize", "batchSize",
        "device batch size; chunks are padded to their power-of-two rung",
        typeConverter=TypeConverters.toInt)

    def setBatchSize(self, value: int) -> "HasBatchSize":
        return self._set(batchSize=value)

    def getBatchSize(self) -> int:
        return self.getOrDefault(self.batchSize)


class HasPriority(Params):
    """The device execution service's admission lane for this
    component's requests (``core/executor.py``): the coalescer drains
    ``"interactive"`` requests first and sheds ``"bulk"`` first. ``None``
    (unset) falls back to ``EngineConfig.executor_default_priority``."""

    priority = Param(
        "HasPriority", "priority",
        "executor admission lane: 'interactive' (drained first, shed "
        "last) or 'bulk' (the batch default). None falls back to "
        "EngineConfig.executor_default_priority",
        typeConverter=SparkDLTypeConverters.toPriority)

    def setPriority(self, value: Optional[str]) -> "HasPriority":
        if value is None:
            self.clear(self.priority)
            return self
        return self._set(priority=value)

    def getPriority(self) -> Optional[str]:
        return (self.getOrDefault(self.priority)
                if self.isDefined(self.priority) else None)


class HasModelFunction(Params):
    """A :class:`sparkdl_tpu_torch.core.model_function.ModelFunction` — or
    a served model NAME (str), resolved through the process-wide serving
    registry at each transform call, so batch transformers follow
    deployments, cutovers and rollbacks as online requests do."""

    modelFunction = Param(
        "HasModelFunction", "modelFunction",
        "ModelFunction to apply (apply fn + nn.Module weights + input "
        "spec), or the name of a serving-registry deployment",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    def setModelFunction(self, value: Any) -> "HasModelFunction":
        return self._set(modelFunction=value)

    def getModelFunction(self):
        value = self.getOrDefault(self.modelFunction)
        if isinstance(value, str):
            # lazy import: param stays importable without serving
            from sparkdl_tpu_torch.serving.registry import default_registry

            return default_registry().model(value)
        return value


class CanLoadImage(Params):
    """Mixin for components that load image files from a URI column.

    Parity: upstream ``CanLoadImage.loadImagesInternal``, a UDF mapping
    URI → decoded image → user preprocessor → image struct. Here the
    decode runs on the host through ``image.imageIO`` (the native loader
    where it is built, Pillow otherwise) into an image-struct column.
    """

    imageLoader = Param(
        "CanLoadImage", "imageLoader",
        "callable URI -> HWC float/uint8 numpy array (decode + preprocess); "
        "None uses the default decode+resize for the model's input size",
        typeConverter=TypeConverters.identity)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(imageLoader=None)

    def setImageLoader(self, value: Optional[Callable]) -> "CanLoadImage":
        if value is None:
            # _set skips None (keyword_only ctor semantics); an explicit
            # None means "back to the default decode+resize"
            self.clear(self.imageLoader)
            return self
        return self._set(imageLoader=value)

    def getImageLoader(self) -> Optional[Callable]:
        return self.getOrDefault(self.imageLoader)

    def loadImagesInternal(self, dataframe, inputCol: str, outputCol: str,
                           target_size=None):
        """Add ``outputCol`` of image structs decoded from URI
        ``inputCol``, partition-parallel on the host.

        The default loader with a known target size decodes each WHOLE
        partition in one ``imageIO.decodeImageFilesBatch`` call: the
        decode pool when ``EngineConfig.decode_workers > 0``, else the
        threaded native batch decoder (GIL released, Pillow for the
        images it rejects). A custom ``imageLoader``, or no target size,
        keeps per-row semantics (``channels=3``, as the batch decoder
        forces RGB).
        """
        from sparkdl_tpu_torch.core import profiling
        from sparkdl_tpu_torch.image import imageIO

        loader = self.getOrDefault(self.imageLoader)

        if loader is None and target_size is not None:
            def load_partition(batch):
                with profiling.annotate("sparkdl.decode"):
                    uris = list(batch.column(inputCol))
                    arrays = imageIO.decodeImageFilesBatch(uris, target_size)
                    return imageIO.imageArraysToStructColumn(
                        arrays, [u or "" for u in uris])

            return dataframe.withColumnBatch(outputCol, load_partition)

        def load_one(uri: str):
            with profiling.annotate("sparkdl.decode"):
                if loader is not None:
                    arr = loader(uri)
                else:
                    arr = imageIO.decodeImageFile(
                        uri, target_size=target_size, channels=3)
                if arr is None:
                    return None
                return imageIO.imageArrayToStruct(arr)

        return dataframe.withColumn(outputCol, load_one, inputCols=[inputCol])
