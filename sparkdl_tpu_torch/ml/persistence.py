"""ML-object persistence: ``stage.save(dir)`` / ``load(dir)``.

A port of ``sparkdl_tpu.ml.persistence``. Layout: ``<dir>/metadata.json``
(``{class, params, artifacts, format_version}``) plus artifact files:

- **Named-model stages** (DeepImageFeaturizer/Predictor): the model name
  and, unless the weights are the seeded ``"random"`` init (then only the
  marker is saved, and the seeded rebuild gives the same weights), the
  module's float32 weights as a torch state dict (``weights.pt``), which
  the registry loads back.
- **LogisticRegressionModel**: ``weights.npz`` (``w``, ``b``).
- **Params-only stages** (evaluators, the unfitted ``LogisticRegression``):
  metadata only.
- **Pipeline / PipelineModel**: one subdirectory per stage, recursively.

``load(dir)`` dispatches on the saved class name, which must be one of
the port's own loadable classes (a guard against metadata pointing at
arbitrary importables). The reference's ModelFunction-backed artifact (a
StableHLO export with the weights baked in) has no port yet, so
``TorchImageTransformer.save`` raises.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict, Optional

_METADATA = "metadata.json"
_WEIGHTS = "weights.pt"

# Only classes registered here can be loaded.
_LOADABLE = {
    "sparkdl_tpu_torch.ml.named_image.DeepImageFeaturizer",
    "sparkdl_tpu_torch.ml.named_image.DeepImagePredictor",
    "sparkdl_tpu_torch.ml.classification.LogisticRegression",
    "sparkdl_tpu_torch.ml.classification.LogisticRegressionModel",
    "sparkdl_tpu_torch.ml.base.Pipeline",
    "sparkdl_tpu_torch.ml.base.PipelineModel",
    "sparkdl_tpu_torch.ml.evaluation.MulticlassClassificationEvaluator",
    "sparkdl_tpu_torch.ml.evaluation.RegressionEvaluator",
    "sparkdl_tpu_torch.ml.evaluation.BinaryClassificationEvaluator",
}


def class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def write_metadata(path: str, instance, params: Dict[str, Any],
                   artifacts: Optional[Dict[str, str]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    meta = {
        "class": class_path(instance),
        "params": params,
        "artifacts": artifacts or {},
        "format_version": 1,
    }
    with open(os.path.join(path, _METADATA), "w") as f:
        json.dump(meta, f, indent=1)


def read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _METADATA)) as f:
        return json.load(f)


def jsonable_params(instance, skip=()) -> Dict[str, Any]:
    """Explicitly-set + defaulted params that JSON-serialize, by name.

    A non-JSON value on an *explicitly set* param raises: dropping it
    silently would reload the stage with different behavior. Unset
    defaults that fail are skipped; the class restores them on
    construction.
    """
    out: Dict[str, Any] = {}
    for param in instance.params:
        if param.name in skip:
            continue
        if not instance.isDefined(param):
            continue
        value = instance.getOrDefault(param)
        try:
            json.dumps(value)
        except TypeError:
            if instance.isSet(param):
                raise ValueError(
                    f"Param {param.name!r}={value!r} is not JSON-"
                    "serializable and would be silently lost on save; "
                    "clear it to persist this stage")
            continue
        out[param.name] = value
    return out


def dtype_name(dtype) -> Optional[str]:
    """A compute dtype (torch dtype or name) as its name, e.g.
    ``"bfloat16"``; None stays None."""
    if dtype is None:
        return None
    return str(dtype).removeprefix("torch.")


def save_state_dict(module, path: str) -> str:
    """An ``nn.Module``'s parameters and buffers as a CPU state dict."""
    import torch

    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    torch.save(state, os.path.join(path, _WEIGHTS))
    return _WEIGHTS


class ParamsOnlyPersistence:
    """save/_load_from for stages whose whole state is their params
    (evaluators, simple unfitted estimators): metadata JSON, no artifacts."""

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        write_metadata(path, self, jsonable_params(self), {})

    @classmethod
    def _load_from(cls, path: str, meta):
        return cls(**meta["params"])


def save_stage_dirs(instance, stages, path: str) -> None:
    """Shared layout for Pipeline/PipelineModel: one subdir per stage."""
    os.makedirs(path, exist_ok=True)
    stage_dirs = []
    for i, stage in enumerate(stages):
        if not hasattr(stage, "save"):
            raise ValueError(
                f"Pipeline stage {i} ({type(stage).__name__}) does not "
                "support save()")
        sub = f"stage_{i:03d}_{type(stage).__name__}"
        stage.save(os.path.join(path, sub))
        stage_dirs.append(sub)
    write_metadata(path, instance, {"stage_dirs": stage_dirs}, {})


def load_stage_dirs(path: str, meta):
    return [load(os.path.join(path, sub))
            for sub in meta["params"]["stage_dirs"]]


def load(path: str):
    """Load any saved stage (``sparkdl_tpu_torch.ml.load``)."""
    meta = read_metadata(path)
    cls_path = meta["class"]
    if cls_path not in _LOADABLE:
        raise ValueError(f"Refusing to load unknown class {cls_path!r}")
    module_name, _, cls_name = cls_path.rpartition(".")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls._load_from(path, meta)
