"""ML-Pipeline API layer of the port (the featurize surface so far)."""

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.ml.named_image import (
    DeepImageFeaturizer, DeepImagePredictor,
)

# Reference-compatible alias, as sparkdl_tpu.ml aliases TPUImageTransformer.
TFImageTransformer = TorchImageTransformer

__all__ = [
    "DeepImageFeaturizer",
    "DeepImagePredictor",
    "TFImageTransformer",
    "TorchImageTransformer",
    "Transformer",
]
