"""ML-Pipeline API layer of the port: the featurize surface, the
pipeline abstractions, the logistic regression that consumes features,
the evaluators and persistence."""

from sparkdl_tpu_torch.ml.base import (
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    Transformer,
)
from sparkdl_tpu_torch.ml.classification import (
    LogisticRegression,
    LogisticRegressionModel,
)
from sparkdl_tpu_torch.ml.evaluation import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.ml.named_image import (
    DeepImageFeaturizer, DeepImagePredictor,
)
from sparkdl_tpu_torch.ml.persistence import load

# Reference-compatible alias, as sparkdl_tpu.ml aliases TPUImageTransformer.
TFImageTransformer = TorchImageTransformer

__all__ = [
    "BinaryClassificationEvaluator",
    "DeepImageFeaturizer",
    "DeepImagePredictor",
    "Estimator",
    "LogisticRegression",
    "LogisticRegressionModel",
    "Model",
    "MulticlassClassificationEvaluator",
    "Pipeline",
    "PipelineModel",
    "RegressionEvaluator",
    "TFImageTransformer",
    "TorchImageTransformer",
    "Transformer",
    "load",
]
