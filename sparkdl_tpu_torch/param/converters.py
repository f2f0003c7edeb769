"""Type converters for set-time param validation.

A copy of ``sparkdl_tpu.param.converters`` cut to what the ported
transformers use: ``pyspark.ml.param.TypeConverters`` plus the
reference's ``SparkDLTypeConverters``.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np


class TypeConverters:
    """Coercing validators mirroring ``pyspark.ml.param.TypeConverters``."""

    @staticmethod
    def identity(value: Any) -> Any:
        return value

    @staticmethod
    def toString(value: Any) -> str:
        if isinstance(value, str):
            return value
        raise TypeError(f"Could not convert {value!r} to string")

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert bool {value!r} to int")
        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise TypeError(f"Could not convert {value!r} to int")

    @staticmethod
    def toFloat(value: Any) -> float:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert bool {value!r} to float")
        if isinstance(value, (int, float, np.integer, np.floating)):
            return float(value)
        raise TypeError(f"Could not convert {value!r} to float")

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"Could not convert {value!r} to bool")


class SparkDLTypeConverters:
    """Framework-specific converters (reference parity)."""

    @staticmethod
    def toColumnName(value: Any) -> str:
        name = TypeConverters.toString(value)
        if not name:
            raise TypeError("column name must be non-empty")
        return name

    @staticmethod
    def toModelFunction(value: Any):
        """Validate a ModelFunction-like object (duck-typed to avoid
        cycles) — or a string naming a serving-registry deployment,
        resolved to the ACTIVE version's model at transform time (so a
        hot-swap reaches batch transformers too)."""
        if isinstance(value, str):
            if not value:
                raise TypeError(
                    "modelFunction name must be non-empty (a serving "
                    "registry deployment name)")
            return value
        if hasattr(value, "apply_fn") and hasattr(value, "variables"):
            return value
        raise TypeError(
            f"Expected a ModelFunction (has .apply_fn/.variables) or a "
            f"served model name (str), got {type(value).__name__}")

    @staticmethod
    def supportedNameConverter(supportedList: List[str]):
        """Converter factory: value must be one of ``supportedList``
        (``modelName`` on ``DeepImagePredictor``/``DeepImageFeaturizer``)."""

        def converter(value: Any) -> str:
            if value in supportedList:
                return value
            raise TypeError(
                f"{value!r} is not in the supported list {supportedList}")

        return converter

    @staticmethod
    def toOutputMode(value: Any) -> str:
        mode = TypeConverters.toString(value)
        if mode not in ("vector", "image"):
            raise TypeError(
                f"outputMode must be 'vector' or 'image', got {mode!r}")
        return mode

    @staticmethod
    def toPriority(value: Any) -> str:
        lane = TypeConverters.toString(value)
        if lane not in ("interactive", "bulk"):
            raise TypeError(
                f"priority must be 'interactive' or 'bulk', got {lane!r}")
        return lane
