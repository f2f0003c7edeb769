"""Shared param mixins used by the ported transformers.

A copy of the mixins of ``sparkdl_tpu.param.shared_params`` that the
featurize path reads; the payload of ``HasModelFunction`` is the port's
:class:`sparkdl_tpu_torch.core.model_function.ModelFunction`.
"""

from __future__ import annotations

from typing import Any, Optional

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
    """A :class:`sparkdl_tpu_torch.core.model_function.ModelFunction`."""

    modelFunction = Param(
        "HasModelFunction", "modelFunction",
        "ModelFunction to apply (apply fn + nn.Module weights + input spec)",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    def setModelFunction(self, value: Any) -> "HasModelFunction":
        return self._set(modelFunction=value)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)
