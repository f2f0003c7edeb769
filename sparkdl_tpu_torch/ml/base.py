"""Pipeline abstractions: ``Transformer`` (Spark ML ``pyspark.ml.base``
semantics, as in ``sparkdl_tpu.ml.base``). ``transform(df, paramMap)``
applies overrides to a *copy*; the receiver is never mutated."""

from __future__ import annotations

from typing import Any, Dict, Optional

from sparkdl_tpu_torch.param.base import Param, Params

ParamMap = Dict[Param, Any]


class Transformer(Params):
    """A fit-free stage: ``transform(df) -> df`` with a new column."""

    def _transform(self, dataset):
        raise NotImplementedError

    def transform(self, dataset, params: Optional[ParamMap] = None):
        if params is None:
            return self._transform(dataset)
        if isinstance(params, dict):
            return self.copy(params)._transform(dataset)
        raise TypeError(f"params must be a param map dict, got {type(params)}")
