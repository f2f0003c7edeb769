"""sparkdl_tpu_torch — Deep Learning Pipelines on PyTorch and CUDA.

The port of ``sparkdl_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Public names follow ``sparkdl_tpu``; the kernels that package wrote in
Pallas are hand-written CUDA C++ for Hopper here (``csrc/``). Models run
on the card by default (``EngineConfig.device = "cuda"``). The package
imports torch, numpy and the standard library only, and nothing of
``sparkdl_tpu``. Submodules load lazily on attribute access.
"""

import logging as _logging

from sparkdl_tpu_torch.version import __version__

_logging.getLogger(__name__).addHandler(_logging.NullHandler())

_LAZY_EXPORTS = {
    "imageIO": ("sparkdl_tpu_torch.image", "imageIO"),
    "readImages": ("sparkdl_tpu_torch.image", "readImages"),
    "readImagesWithCustomFn": ("sparkdl_tpu_torch.image",
                               "readImagesWithCustomFn"),
    "DataFrame": ("sparkdl_tpu_torch.engine", "DataFrame"),
    "EngineConfig": ("sparkdl_tpu_torch.engine", "EngineConfig"),
    "Transformer": ("sparkdl_tpu_torch.ml", "Transformer"),
    "TorchImageTransformer": ("sparkdl_tpu_torch.ml",
                              "TorchImageTransformer"),
    "TFImageTransformer": ("sparkdl_tpu_torch.ml", "TFImageTransformer"),
    "DeepImageFeaturizer": ("sparkdl_tpu_torch.ml", "DeepImageFeaturizer"),
    "DeepImagePredictor": ("sparkdl_tpu_torch.ml", "DeepImagePredictor"),
    "Estimator": ("sparkdl_tpu_torch.ml", "Estimator"),
    "Model": ("sparkdl_tpu_torch.ml", "Model"),
    "Pipeline": ("sparkdl_tpu_torch.ml", "Pipeline"),
    "PipelineModel": ("sparkdl_tpu_torch.ml", "PipelineModel"),
    "LogisticRegression": ("sparkdl_tpu_torch.ml", "LogisticRegression"),
    "LogisticRegressionModel": ("sparkdl_tpu_torch.ml",
                                "LogisticRegressionModel"),
    "MulticlassClassificationEvaluator": (
        "sparkdl_tpu_torch.ml", "MulticlassClassificationEvaluator"),
    "RegressionEvaluator": ("sparkdl_tpu_torch.ml", "RegressionEvaluator"),
    "BinaryClassificationEvaluator": ("sparkdl_tpu_torch.ml",
                                      "BinaryClassificationEvaluator"),
    "load": ("sparkdl_tpu_torch.ml", "load"),
    "sql": ("sparkdl_tpu_torch.engine", "sql"),
    "table": ("sparkdl_tpu_torch.engine", "table"),
    "registerUDF": ("sparkdl_tpu_torch.udf", "registerUDF"),
    "registerImageUDF": ("sparkdl_tpu_torch.udf", "registerImageUDF"),
    # observability
    "Telemetry": ("sparkdl_tpu_torch.core", "Telemetry"),
    "telemetry": ("sparkdl_tpu_torch.core", "telemetry"),
    "HealthMonitor": ("sparkdl_tpu_torch.core", "HealthMonitor"),
    "slo": ("sparkdl_tpu_torch.core", "slo"),
    "SLORule": ("sparkdl_tpu_torch.core", "SLORule"),
    "SLOWatchdog": ("sparkdl_tpu_torch.core", "SLOWatchdog"),
    # online serving
    "ModelServer": ("sparkdl_tpu_torch.serving", "ModelServer"),
    "ModelRegistry": ("sparkdl_tpu_torch.serving", "ModelRegistry"),
    "ResidencyManager": ("sparkdl_tpu_torch.serving", "ResidencyManager"),
    # training surface
    "Trainer": ("sparkdl_tpu_torch.train", "Trainer"),
    "TrainState": ("sparkdl_tpu_torch.train", "TrainState"),
    "CheckpointManager": ("sparkdl_tpu_torch.train", "CheckpointManager"),
    "MetricsLogger": ("sparkdl_tpu_torch.train", "MetricsLogger"),
    "make_loss": ("sparkdl_tpu_torch.train", "make_loss"),
    "make_optimizer": ("sparkdl_tpu_torch.train", "make_optimizer"),
}

__all__ = ["__version__"] + sorted(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'sparkdl_tpu_torch' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value
