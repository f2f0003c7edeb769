"""Named-model registry, ported from ``sparkdl_tpu.models.registry``.

Each entry carries the module builder, the fixed input size, the
device-side preprocessing function, and the feature dimension. Weight
sources for :func:`build_featurizer` / :func:`build_predictor`:

- ``"random"`` (or None): a seeded init from a ``torch.Generator`` on the
  CPU (Flax's default initializers), so every device gets the same
  weights from the same seed;
- a Flax ``{"params", "batch_stats"}`` tree of numpy arrays, converted by
  ``models/convert.py`` — how the JAX package's weights come across;
- a PyTorch state dict, or the path of one saved with ``torch.save``.

Every Flax-native name of the reference's registry is ported (Xception,
InceptionV3, ResNet50/101/152, VGG16/19, MobileNetV2, TestNet); its
ingestion-backed names raise a clear "not yet ported" error. InceptionV3
builds its inference fast path (``models/inception_fast.py``) unless
``fast=False`` asks for the module, as in the reference; ResNet's fast
apply (``models/resnet_fast.py``) is not selected, as there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from sparkdl_tpu_torch.core.model_function import (
    ModelFunction, TensorSpec, torch_dtype,
)
from sparkdl_tpu_torch.models import layers
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.inception import InceptionV3
from sparkdl_tpu_torch.models.inception_fast import inception_v3_fast_apply
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.resnet import ResNet50, ResNet101, ResNet152
from sparkdl_tpu_torch.models.testnet import TestNet
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception

# ---------------------------------------------------------------------------
# Device-side preprocessing (input: float RGB in [0, 255], NHWC)
# ---------------------------------------------------------------------------

_CAFFE_MEAN = (103.939, 116.779, 123.68)  # BGR means, keras 'caffe' mode
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def _constant(values: Tuple[float, ...], like: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of ``like``'s dtype on its device, made once
    per (values, dtype, device): a forward makes no host-to-device copy
    of its own, so it can be captured in a CUDA graph."""
    key = (values, like.dtype, like.device)
    const = _CONSTANTS.get(key)
    if const is None:
        with torch.inference_mode(False):  # usable outside inference too
            const = torch.tensor(values, dtype=like.dtype,
                                 device=like.device)
        const = _CONSTANTS.setdefault(key, const)
    return const


def preprocess_tf_mode(x: torch.Tensor) -> torch.Tensor:
    """keras 'tf' mode: scale to [-1, 1]."""
    return x / 127.5 - 1.0


def preprocess_caffe_mode(x: torch.Tensor) -> torch.Tensor:
    """keras 'caffe' mode: RGB->BGR, subtract ImageNet means."""
    x = x.flip(-1)
    return x - _constant(_CAFFE_MEAN, x)


def preprocess_torch_mode(x: torch.Tensor) -> torch.Tensor:
    """keras 'torch' mode: [0,1] scale then ImageNet RGB mean/std."""
    x = x / 255.0
    return (x - _constant(_TORCH_MEAN, x)) / _constant(_TORCH_STD, x)


def preprocess_identity(x: torch.Tensor) -> torch.Tensor:
    return x


PREPROCESS_MODES: Dict[str, Callable] = {
    "tf": preprocess_tf_mode,
    "caffe": preprocess_caffe_mode,
    "torch": preprocess_torch_mode,
    "identity": preprocess_identity,
}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    builder: Callable[..., nn.Module]    # kwargs -> nn.Module
    input_size: Tuple[int, int]          # (H, W)
    preprocess: Callable                 # device-side, on tensors
    feature_dim: int
    classes: int = 1000
    # kwargs of the featurize variant (None: include_top=False,
    # pooling="avg")
    featurize_kwargs: Optional[Dict[str, Any]] = None
    # forward FLOPs per image at the input size (2·MACs), the reference
    # spec's figure; None = unknown
    flops_per_image: Optional[float] = None


SUPPORTED_MODELS: Dict[str, ModelSpec] = {
    "InceptionV3": ModelSpec(
        "InceptionV3", InceptionV3, (299, 299), preprocess_tf_mode, 2048,
        flops_per_image=5.7e9),
    "ResNet50": ModelSpec(
        "ResNet50", ResNet50, (224, 224), preprocess_caffe_mode, 2048,
        flops_per_image=7.75e9),
    "ResNet101": ModelSpec(
        "ResNet101", ResNet101, (224, 224), preprocess_caffe_mode, 2048),
    "ResNet152": ModelSpec(
        "ResNet152", ResNet152, (224, 224), preprocess_caffe_mode, 2048),
    "Xception": ModelSpec(
        "Xception", Xception, (299, 299), preprocess_tf_mode, 2048),
    "VGG16": ModelSpec(
        "VGG16", VGG16, (224, 224), preprocess_caffe_mode, 4096,
        featurize_kwargs={"include_top": True, "features_at_fc2": True}),
    "VGG19": ModelSpec(
        "VGG19", VGG19, (224, 224), preprocess_caffe_mode, 4096,
        featurize_kwargs={"include_top": True, "features_at_fc2": True}),
    "MobileNetV2": ModelSpec(
        "MobileNetV2", MobileNetV2, (224, 224), preprocess_tf_mode, 1280),
    "TestNet": ModelSpec(
        "TestNet", TestNet, (32, 32), preprocess_tf_mode, 16, classes=10),
}

#: Every name the JAX package's registry serves; those not in
#: :data:`SUPPORTED_MODELS` (its ingestion-backed names) are not ported
#: yet.
REFERENCE_MODEL_NAMES = sorted([
    "InceptionV3", "ResNet50", "ResNet101", "ResNet152", "Xception",
    "VGG16", "VGG19", "MobileNetV2", "TestNet", "DenseNet121",
    "EfficientNetB0", "MobileNetV3Small", "NASNetMobile", "ResNet50V2",
    "EfficientNetV2B0", "ConvNeXtTiny", "DenseNet169", "DenseNet201",
    "ResNet101V2", "ResNet152V2", "EfficientNetB1", "MobileNetV3Large",
])
SUPPORTED_MODEL_NAMES = sorted(SUPPORTED_MODELS)


def get_model_spec(name: str) -> ModelSpec:
    spec = SUPPORTED_MODELS.get(name)
    if spec is not None:
        return spec
    if name in REFERENCE_MODEL_NAMES:
        raise NotImplementedError(
            f"Model {name!r} is not yet ported to sparkdl_tpu_torch; "
            f"ported: {SUPPORTED_MODEL_NAMES}")
    raise ValueError(
        f"Unsupported model {name!r}; supported: {SUPPORTED_MODEL_NAMES}")


def _random_init(module: nn.Module, seed: int) -> None:
    """Flax's default initializers from a seeded CPU generator: conv and
    Dense kernels lecun-normal, biases zero, BN γ=1, β=0, mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, (layers.Conv2d, layers.Dense)):
            layers.lecun_normal_(sub.weight, gen)


def _resolve_weights(module: nn.Module, name: str, weights, seed: int
                     ) -> None:
    if weights is None or (isinstance(weights, str) and weights == "random"):
        _random_init(module, seed)
        return
    if isinstance(weights, str):
        state = torch.load(weights, map_location="cpu", weights_only=True)
    elif isinstance(weights, dict) and "params" in weights:
        state = from_flax_variables(name, weights)
    elif isinstance(weights, dict):
        state = weights
    else:
        raise TypeError(
            f"Cannot resolve weights for {name!r} from "
            f"{type(weights).__name__}; pass 'random', a Flax variables "
            "tree of numpy arrays, a state dict, or a state-dict file")
    # a head-less module takes the head-less part of a full model's weights
    wanted = module.state_dict()
    state = {k: v for k, v in state.items() if k in wanted}
    module.load_state_dict(state, strict=True)


def _spec_input(spec: ModelSpec) -> TensorSpec:
    h, w = spec.input_size
    return TensorSpec((None, h, w, 3), "float32")


def _fast_inference_apply(name: str, include_top: bool, dtype
                          ) -> Optional[Callable]:
    """Inference-specialized apply for models that have one, else None:
    InceptionV3's (BN folded, branch 1×1 convs fused), computing in
    ``dtype`` (None = float32)."""
    if name != "InceptionV3":
        return None
    compute_dtype = torch_dtype(dtype) if dtype is not None else torch.float32

    def apply_fn(module, x):
        return inception_v3_fast_apply(module, x, include_top=include_top,
                                       pooling="avg",
                                       compute_dtype=compute_dtype)

    return apply_fn


def _build(name: str, include_top: bool, weights, seed: int, dtype,
           preprocess: bool, fast: bool,
           precision: Optional[str]) -> ModelFunction:
    """The module built with ``dtype`` as every layer's compute dtype
    (the reference's Flax ``dtype``: float32 weights and statistics, each
    op cast), so the result stays :attr:`ModelFunction.kernel_routable`
    as ``fromFlax`` is; InceptionV3's fast apply computes in ``dtype``."""
    spec = get_model_spec(name)
    compute = torch_dtype(dtype) if dtype is not None else None
    if include_top:
        kwargs = {"include_top": True, "classes": spec.classes}
    else:
        kwargs = dict(spec.featurize_kwargs
                      or {"include_top": False, "pooling": "avg"})
    module = spec.builder(**kwargs, dtype=compute)
    _resolve_weights(module, name, weights, seed)
    kind = "predict" if include_top else "featurize"
    fast_apply = _fast_inference_apply(name, include_top, dtype) if fast \
        else None
    if fast_apply is not None:
        # dtype is the fast apply's compute dtype; the weights stay float32
        mf = ModelFunction.fromFunction(fast_apply, module, _spec_input(spec),
                                        name=f"{name}_{kind}")
    else:
        mf = ModelFunction.fromModule(module, _spec_input(spec),
                                      name=f"{name}_{kind}")
    if preprocess:
        mf = mf.with_preprocess(spec.preprocess)
    mf.fast_path = fast_apply is not None
    return _apply_precision(mf, precision)


def _apply_precision(mf: ModelFunction,
                     precision: Optional[str]) -> ModelFunction:
    """``with_dtype(precision)``, keeping ``fast_path`` on the result; None
    or ``"float32"`` leaves the model as it is."""
    if precision is None or precision == "float32":
        return mf
    out = mf.with_dtype(precision)
    out.fast_path = mf.fast_path
    return out


def build_featurizer(name: str, weights="random", seed: int = 0,
                     dtype=None, preprocess: bool = True, fast: bool = True,
                     precision: Optional[str] = None) -> ModelFunction:
    """Headless named model as a ModelFunction emitting feature vectors.

    Input contract: float RGB [0, 255] NHWC at the model's input size;
    scaling runs on the device (``preprocess=False`` leaves it out).
    ``dtype`` (None = float32) is the compute dtype of every layer.
    ``fast=False`` builds the module apply even where an
    inference-specialized fast path exists. ``precision`` applies
    :meth:`ModelFunction.with_dtype` to the finished featurizer (None or
    ``"float32"`` leaves it as it is): the executor applies
    ``EngineConfig.inference_precision`` itself, so this is for use of
    the registry outside the engine."""
    return _build(name, False, weights, seed, dtype, preprocess, fast,
                  precision)


def build_predictor(name: str, weights="random", seed: int = 0,
                    dtype=None, preprocess: bool = True, fast: bool = True,
                    precision: Optional[str] = None) -> ModelFunction:
    """Full named model (softmax probabilities) as a ModelFunction;
    ``precision`` as in :func:`build_featurizer`."""
    return _build(name, True, weights, seed, dtype, preprocess, fast,
                  precision)
