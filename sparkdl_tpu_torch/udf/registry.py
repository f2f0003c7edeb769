"""Named UDF registry + registration helpers.

A port of ``sparkdl_tpu.udf.registry``. A registered UDF is an object
with ``apply(df, input_cols, output_col) -> df``, uniform for plain row
functions and model UDFs on the card, so ``selectExpr`` can invoke any
of them by name. The registry is process-wide and guarded by a lock.
``registerTensorUDF`` waits for ``ml/tensor_transformer.py`` and
``registerKerasImageUDF`` for Keras ingestion; both raise.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np


class ColumnUDF:
    """A named column operator: ``apply(df, input_cols, output_col)``.

    ``arity``: number of input columns the UDF consumes; model UDFs are
    unary (one image column), plain row functions take any arity (None:
    unchecked).
    """

    def __init__(self, name: str, apply_fn: Callable, kind: str,
                 arity: Optional[int] = 1) -> None:
        self.name = name
        self._apply_fn = apply_fn
        self.kind = kind
        self.arity = arity

    def apply(self, df, input_cols, output_col: str):
        if isinstance(input_cols, str):
            input_cols = [input_cols]
        if self.arity is not None and len(input_cols) != self.arity:
            raise ValueError(
                f"UDF {self.name!r} takes {self.arity} argument(s), "
                f"got {len(input_cols)}")
        if self.arity == 1:
            return self._apply_fn(df, input_cols[0], output_col)
        return self._apply_fn(df, input_cols, output_col)

    def __repr__(self) -> str:
        return f"ColumnUDF({self.name!r}, kind={self.kind!r})"


class UDFRegistry:
    """Process-wide named UDFs (the SQL-function namespace analog)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._udfs: Dict[str, ColumnUDF] = {}

    def register(self, udf: ColumnUDF, replace: bool = True) -> ColumnUDF:
        with self._lock:
            if not replace and udf.name in self._udfs:
                raise ValueError(f"UDF {udf.name!r} already registered")
            self._udfs[udf.name] = udf
        return udf

    def get(self, name: str) -> ColumnUDF:
        with self._lock:
            try:
                return self._udfs[name]
            except KeyError:
                raise KeyError(
                    f"No UDF named {name!r}; registered: "
                    f"{sorted(self._udfs)}") from None

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._udfs

    def unregister(self, name: str) -> None:
        with self._lock:
            self._udfs.pop(name, None)

    def names(self):
        with self._lock:
            return sorted(self._udfs)


udf_registry = UDFRegistry()


def registerUDF(name: str, fn: Callable, outputType=None, arity: int = 1,
                registry: Optional[UDFRegistry] = None) -> ColumnUDF:
    """Register a plain row function ``(*values) -> value`` under ``name``.

    ``arity``: how many columns the function consumes (``selectExpr``
    passes that many arguments). ``outputType`` is accepted for the
    reference's signature; the port's columns are untyped, so it has no
    effect.
    """
    del outputType

    def apply_fn(df, input_cols, output_col):
        if isinstance(input_cols, str):
            input_cols = [input_cols]
        return df.withColumn(output_col, fn, inputCols=list(input_cols))

    return (registry or udf_registry).register(
        ColumnUDF(name, apply_fn, "row",
                  arity=None if arity is None else int(arity)))


def registerTensorUDF(name: str, modelFunction, batchSize: int = 64,
                      registry: Optional[UDFRegistry] = None) -> ColumnUDF:
    """Not ported yet: it applies ``ml/tensor_transformer.py``'s
    ``TPUTransformer``, which the port does not have."""
    raise NotImplementedError(
        "registerTensorUDF is not yet ported to sparkdl_tpu_torch: it "
        "needs ml/tensor_transformer.py (TPUTransformer)")


def registerImageUDF(name: str, modelFunction, batchSize: int = 64,
                     preprocessor: Optional[Callable] = None,
                     registry: Optional[UDFRegistry] = None) -> ColumnUDF:
    """Register a ModelFunction over image-struct columns under ``name``.

    The UDF is a :class:`TorchImageTransformer` with ``outputMode=
    "vector"`` over the argument column, so it runs where the transformer
    runs (``EngineConfig.device``). ``preprocessor`` (optional): host-side
    ``HWC ndarray -> HWC ndarray`` applied per image before staging. The
    reference's ``mesh`` argument waits for the port's mesh module.
    """

    def apply_fn(df, input_col, output_col):
        from sparkdl_tpu_torch.image import imageIO
        from sparkdl_tpu_torch.ml.image_transformer import (
            TorchImageTransformer,
        )

        frame = df
        model_input = input_col
        if preprocessor is not None:
            tmp = output_col + "__pre"

            def pre(struct):
                if struct is None:
                    return None
                arr = preprocessor(imageIO.imageStructToArray(struct))
                return imageIO.imageArrayToStruct(
                    np.asarray(arr), origin=struct.get("origin", ""))

            frame = df.withColumn(tmp, pre, inputCols=[input_col])
            model_input = tmp
        out = TorchImageTransformer(
            inputCol=model_input, outputCol=output_col,
            modelFunction=modelFunction, outputMode="vector",
            batchSize=batchSize).transform(frame)
        if model_input != input_col:
            out = out.drop(model_input)
        return out

    return (registry or udf_registry).register(
        ColumnUDF(name, apply_fn, "image_model"))


def registerKerasImageUDF(udfName: str, kerasModelOrFile: Any,
                          preprocessor: Optional[Callable] = None,
                          batchSize: int = 64,
                          registry: Optional[UDFRegistry] = None
                          ) -> ColumnUDF:
    """Not ported yet: it ingests a Keras model through
    ``models/keras_ingest.py``, which the port does not have."""
    raise NotImplementedError(
        "registerKerasImageUDF is not yet ported to sparkdl_tpu_torch: it "
        "needs Keras ingestion (models/keras_ingest.py)")
