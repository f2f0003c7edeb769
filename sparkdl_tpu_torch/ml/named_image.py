"""DeepImagePredictor / DeepImageFeaturizer — named pre-trained models.

A port of ``sparkdl_tpu.ml.named_image``: the named model comes from the
port's registry, and featurize/predict run through
:class:`~sparkdl_tpu_torch.ml.image_transformer.TorchImageTransformer`.
``DeepImagePredictor(decodePredictions=True)`` emits top-K ``(class,
description, probability)`` rows over the model's own classes, labelled
from a local Keras class index where one exists, else ``class_<i>``.
Both save and load (``ml/persistence.py``) with their ``dtype``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.converters import (
    SparkDLTypeConverters, TypeConverters,
)
from sparkdl_tpu_torch.param.shared_params import (
    HasBatchSize, HasInputCol, HasOutputCol,
)

logger = logging.getLogger(__name__)

SUPPORTED_MODELS = registry.REFERENCE_MODEL_NAMES


class _NamedImageTransformer(Transformer, HasInputCol, HasOutputCol,
                             HasBatchSize):
    """Shared plumbing: modelName param + cached ModelFunction build."""

    modelName = Param(
        "_NamedImageTransformer", "modelName",
        f"name of the pre-trained model, one of {SUPPORTED_MODELS} "
        f"(ported so far: {registry.SUPPORTED_MODEL_NAMES})",
        typeConverter=SparkDLTypeConverters.supportedNameConverter(
            SUPPORTED_MODELS))
    weights = Param(
        "_NamedImageTransformer", "weights",
        "weight source: 'random' (seeded init), a Flax variables tree of "
        "numpy arrays, a PyTorch state dict, or a state-dict file",
        typeConverter=TypeConverters.identity)
    dtype = Param(
        "_NamedImageTransformer", "dtype",
        "compute dtype on the device (e.g. torch.bfloat16); None computes "
        "in float32",
        typeConverter=TypeConverters.identity)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(batchSize=64, weights="random", dtype=None)
        self._mf_cache = {}

    def setModelName(self, value: str):
        return self._set(modelName=value)

    def getModelName(self) -> str:
        return self.getOrDefault(self.modelName)

    def setWeights(self, value):
        return self._set(weights=value)

    def getWeights(self):
        return self.getOrDefault(self.weights)

    def setDtype(self, value):
        return self._set(dtype=value)

    def getDtype(self):
        return self.getOrDefault(self.dtype)

    def _model_function(self, kind: str):
        name = self.getModelName()
        weights = self.getWeights()
        dtype = self.getDtype()
        # keyed by (kind, name, dtype), validated against the exact weights
        # object/path so a new weights value never hits a stale entry
        key = (kind, name, str(dtype))
        cached = self._mf_cache.get(key)
        if cached is not None:
            cached_weights, mf = cached
            if cached_weights is weights or (
                    isinstance(weights, str) and cached_weights == weights):
                return mf
        build = (registry.build_featurizer if kind == "featurize"
                 else registry.build_predictor)
        mf = build(name, weights=weights, dtype=dtype)
        self._mf_cache[key] = (weights, mf)
        return mf

    def copy(self, extra=None):
        # copies share the built-model cache (entries validate against the
        # exact weights value)
        that = super().copy(extra)
        that._mf_cache = dict(self._mf_cache)
        return that

    # -- persistence (see ml/persistence.py) ---------------------------------

    _persist_kind = "featurize"

    def save(self, path: str) -> None:
        """``metadata.json`` with the params and the compute ``dtype``'s
        name; the seeded ``"random"`` init saves only its marker, any
        other weights the built module's state dict (``weights.pt``)."""
        from sparkdl_tpu_torch.ml import persistence as P

        os.makedirs(path, exist_ok=True)
        params = P.jsonable_params(self, skip=("weights", "dtype"))
        params["dtype"] = P.dtype_name(self.getDtype())
        artifacts = {}
        weights = self.getWeights()
        if isinstance(weights, str) and weights == "random":
            params["weights"] = "random"
        else:
            module = self._model_function(self._persist_kind).variables
            artifacts["weights"] = P.save_state_dict(module, path)
        P.write_metadata(path, self, params, artifacts)

    @classmethod
    def _load_from(cls, path: str, meta):
        from sparkdl_tpu_torch.core.model_function import torch_dtype

        kwargs = dict(meta["params"])
        dtype = kwargs.pop("dtype", None)
        if "weights" in meta["artifacts"]:
            kwargs["weights"] = os.path.join(path,
                                             meta["artifacts"]["weights"])
        inst = cls(**kwargs)
        if dtype is not None:
            inst.setDtype(torch_dtype(dtype))
        return inst


class DeepImageFeaturizer(_NamedImageTransformer):
    """Headless named CNN → feature-vector column (transfer learning)."""

    @keyword_only
    def __init__(self, *, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelName: Optional[str] = None,
                 weights="random",
                 batchSize: int = 64,
                 dtype=None) -> None:
        super().__init__()
        self.setParams(**self._input_kwargs)

    @keyword_only
    def setParams(self, *, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelName: Optional[str] = None,
                  weights="random",
                  batchSize: int = 64,
                  dtype=None) -> "DeepImageFeaturizer":
        return self._set(**self._input_kwargs)

    def _transform(self, dataset):
        inner = TorchImageTransformer(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
            modelFunction=self._model_function("featurize"),
            outputMode="vector", batchSize=self.getBatchSize())
        return inner.transform(dataset)


class DeepImagePredictor(_NamedImageTransformer):
    """Full named CNN → class-probability column, optionally decoded top-K."""

    _persist_kind = "predict"

    decodePredictions = Param(
        "DeepImagePredictor", "decodePredictions",
        "when true, output a list of top-K (class, description, probability) "
        "structs instead of the raw probability vector",
        typeConverter=TypeConverters.toBoolean)
    topK = Param("DeepImagePredictor", "topK",
                 "how many top classes to keep when decoding",
                 typeConverter=TypeConverters.toInt)

    @keyword_only
    def __init__(self, *, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelName: Optional[str] = None,
                 weights="random",
                 decodePredictions: bool = False,
                 topK: int = 5,
                 batchSize: int = 64,
                 dtype=None) -> None:
        super().__init__()
        self._setDefault(decodePredictions=False, topK=5)
        self.setParams(**self._input_kwargs)

    @keyword_only
    def setParams(self, *, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelName: Optional[str] = None,
                  weights="random",
                  decodePredictions: bool = False,
                  topK: int = 5,
                  batchSize: int = 64,
                  dtype=None) -> "DeepImagePredictor":
        return self._set(**self._input_kwargs)

    def _transform(self, dataset):
        out_col = self.getOutputCol()
        decode = self.getOrDefault(self.decodePredictions)
        raw_col = out_col if not decode else out_col + "__raw"
        inner = TorchImageTransformer(
            inputCol=self.getInputCol(), outputCol=raw_col,
            modelFunction=self._model_function("predict"),
            outputMode="vector", batchSize=self.getBatchSize())
        frame = inner.transform(dataset)
        if not decode:
            return frame
        k = self.getOrDefault(self.topK)
        labels = imagenet_labels(
            registry.get_model_spec(self.getModelName()).classes)

        def decode_row(probs):
            # a null input cell (undecodable image upstream) or a malformed
            # probability vector becomes a null decoded cell
            if probs is None:
                return None
            try:
                p = np.asarray(probs, dtype=np.float32)
                top = np.argsort(-p, kind="stable")[:k]
                return [{"class": labels[i][0], "description": labels[i][1],
                         "probability": float(p[i])} for i in top]
            except (ValueError, TypeError, IndexError) as e:
                logger.warning(
                    "DeepImagePredictor: undecodable probability row "
                    "(%s: %s) — emitting null", type(e).__name__, e)
                return None

        frame = frame.withColumn(out_col, decode_row, inputCols=[raw_col])
        return frame.drop(raw_col)


def imagenet_labels(n_classes: int = 1000):
    """[(wnid, human_name)] from a local copy of Keras's
    ``imagenet_class_index.json`` (``~/.keras/models/``, then
    ``~/.keras/``) where one exists and reads whole, else stable
    ``class_<i>`` ids. Nothing is downloaded."""
    candidates = [
        os.path.expanduser("~/.keras/models/imagenet_class_index.json"),
        os.path.expanduser("~/.keras/imagenet_class_index.json"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    index = json.load(f)
                return [tuple(index[str(i)]) for i in range(n_classes)]
            except (OSError, KeyError, json.JSONDecodeError):
                break
    return [(f"class_{i}", f"class_{i}") for i in range(n_classes)]
