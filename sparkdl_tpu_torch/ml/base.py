"""Pipeline abstractions: Transformer / Estimator / Model / Pipeline.

A port of ``sparkdl_tpu.ml.base`` (Spark ML's ``pyspark.ml.base`` +
``pyspark.ml.pipeline`` semantics), on the port's DataFrame:

- ``fit(df)`` / ``fit(df, paramMap)`` / ``fit(df, [paramMap, ...])``: a
  list of maps trains one model per map.
- ``fitMultiple(df, paramMaps)`` returns a thread-safe iterator of
  ``(index, model)``; indices may complete out of order.
- ``transform(df, paramMap)`` applies overrides to a *copy*; the receiver
  is never mutated.
- ``Pipeline(stages=[...])`` fits estimator stages on the running
  intermediate frame and returns a ``PipelineModel`` of transformers;
  stages after the last estimator are not materialized during ``fit``,
  and ``Pipeline.copy`` fans its ``extra`` out to every stage.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

from sparkdl_tpu_torch.param.base import Param, Params, keyword_only

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


class Estimator(Params):
    """A trainable stage: ``fit(df) -> Model``."""

    def _fit(self, dataset) -> "Model":
        raise NotImplementedError

    def fit(self, dataset, params: Optional[Union[ParamMap, Sequence[ParamMap]]] = None):
        if params is None:
            return self._fit(dataset)
        if isinstance(params, dict):
            return self.copy(params)._fit(dataset)
        if isinstance(params, (list, tuple)):
            models: List[Optional[Model]] = [None] * len(params)
            for index, model in self.fitMultiple(dataset, params):
                models[index] = model
            return models
        raise TypeError(
            f"params must be a param map or a list/tuple of them, got {type(params)}")

    def fitMultiple(self, dataset, paramMaps: Sequence[ParamMap]
                    ) -> Iterator[Tuple[int, "Model"]]:
        """Iterator of ``(index, model)``; safe to drain from threads.

        Parity: ``pyspark.ml.Estimator.fitMultiple``. The default fits
        lazily on ``next()``; subclasses override to share work.
        """
        estimator = self.copy()

        class _FitMultipleIterator:
            def __init__(self) -> None:
                self._lock = threading.Lock()
                self._next = 0

            def __iter__(self):
                return self

            def __next__(self) -> Tuple[int, Model]:
                with self._lock:
                    index = self._next
                    if index >= len(paramMaps):
                        raise StopIteration
                    self._next += 1
                return index, estimator.fit(dataset, paramMaps[index])

        return _FitMultipleIterator()


class Model(Transformer):
    """A Transformer produced by an Estimator; tracks its parent."""

    parent: Optional[Estimator] = None

    def _set_parent(self, parent: Estimator) -> "Model":
        self.parent = parent
        return self


class Pipeline(Estimator):
    """Ordered stages; estimator stages are fit on the running frame.

    Parity: ``pyspark.ml.Pipeline``, the container the reference's
    flagship workflow puts ``DeepImageFeaturizer`` into, ahead of a
    ``LogisticRegression``.
    """

    stages = Param("Pipeline", "stages", "pipeline stages (Transformer/Estimator)")

    @keyword_only
    def __init__(self, *, stages: Optional[List[Params]] = None) -> None:
        super().__init__()
        self._set(stages=stages or [])

    def setStages(self, value: List[Params]) -> "Pipeline":
        return self._set(stages=value)

    def getStages(self) -> List[Params]:
        return self.getOrDefault(self.stages)

    def _fit(self, dataset) -> "PipelineModel":
        stages = self.getStages()
        for stage in stages:
            if not isinstance(stage, (Transformer, Estimator)):
                raise TypeError(
                    f"Pipeline stage must be Estimator or Transformer, got {stage!r}")
        # Frames after the last estimator need no materialization: later
        # transformers only run at PipelineModel.transform time.
        last_estimator = -1
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                last_estimator = i
        fitted: List[Transformer] = []
        frame = dataset
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(frame)
                fitted.append(model)
                if i < last_estimator:
                    frame = model.transform(frame)
            else:
                fitted.append(stage)
                if i < last_estimator:
                    frame = stage.transform(frame)
        return PipelineModel(fitted)._set_parent(self)

    def copy(self, extra: Optional[ParamMap] = None) -> "Pipeline":
        # extra fans out to every stage; each stage's copy keeps only the
        # params it owns (pyspark Pipeline.copy semantics — this is how one
        # param map addresses individual stages during HPO).
        that = super().copy(extra)
        that._set(stages=[
            s.copy(extra) if isinstance(s, Params) else s
            for s in that.getStages()])
        return that

    # -- persistence: unfitted pipeline --------------------------------------

    def save(self, path: str) -> None:
        """Persist the UNFITTED pipeline — one subdirectory per stage
        (transformers and unfitted estimators alike), so a training
        pipeline can be saved, reloaded, and then fit."""
        from sparkdl_tpu_torch.ml import persistence as P

        P.save_stage_dirs(self, self.getStages(), path)

    @classmethod
    def _load_from(cls, path: str, meta):
        from sparkdl_tpu_torch.ml import persistence as P

        return cls(stages=P.load_stage_dirs(path, meta))


class PipelineModel(Model):
    """The fitted pipeline: a chain of transformers."""

    def __init__(self, stages: List[Transformer]) -> None:
        super().__init__()
        self.stages = stages

    def _transform(self, dataset):
        frame = dataset
        for stage in self.stages:
            frame = stage.transform(frame)
        return frame

    def copy(self, extra: Optional[ParamMap] = None) -> "PipelineModel":
        that = PipelineModel([s.copy(extra) for s in self.stages])
        that.parent = self.parent
        return that

    # -- persistence: one subdirectory per stage -----------------------------

    def save(self, path: str) -> None:
        from sparkdl_tpu_torch.ml import persistence as P

        P.save_stage_dirs(self, self.stages, path)

    @classmethod
    def _load_from(cls, path: str, meta):
        from sparkdl_tpu_torch.ml import persistence as P

        return cls(P.load_stage_dirs(path, meta))
