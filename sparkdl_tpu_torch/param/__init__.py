"""Spark-ML-style ``Params`` system (a copy of ``sparkdl_tpu.param``, cut
to the mixins the ported transformers and loaders use)."""

from sparkdl_tpu_torch.param.base import Param, Params, keyword_only
from sparkdl_tpu_torch.param.converters import (
    SparkDLTypeConverters, TypeConverters,
)
from sparkdl_tpu_torch.param.shared_params import (
    CanLoadImage,
    HasBatchSize,
    HasInputCol,
    HasLabelCol,
    HasModelFunction,
    HasOutputCol,
    HasOutputMode,
)

__all__ = [
    "Param",
    "Params",
    "keyword_only",
    "TypeConverters",
    "SparkDLTypeConverters",
    "HasInputCol",
    "HasLabelCol",
    "HasOutputCol",
    "HasOutputMode",
    "HasBatchSize",
    "HasModelFunction",
    "CanLoadImage",
]
