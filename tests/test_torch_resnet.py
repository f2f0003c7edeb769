"""ResNet in the port against the JAX package: the residual block, ResNet50
whole, ResNet101/152's trees, the fast apply, the bf16 flow and the
featurizer slice.

Cost: one ResNet50 variables tree (``jax.eval_shape`` of the Flax init,
filled from numpy) at 32×32, where the network still runs all 16 blocks
at full width; batch 2; each JAX reference is jitted once. The slice
runs at the registry's 224×224 on two images.

Tolerances:
- float32, one layer: max|Δ| ≤ 1e-5·max(1, max|ref|) (sums reassociate);
- float32, whole model or slice: max|Δ| ≤ 1e-3·max|ref| (53 conv layers
  of reassociated sums; the fast apply's folded BN against the module's
  unfolded BN);
- bfloat16: max|Δ| ≤ 0.05 (``BF16_TOLERANCE``), relative to max(1,
  max|ref|) where the values are on the caffe scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.core.kernels import BF16_TOLERANCE
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.models.resnet_fast import (
    resnet_fast_apply as jax_resnet_fast_apply,
)
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import registry, resnet
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.resnet_fast import resnet_fast_apply
from tests.torch_port_helpers import (
    column, frames, headless, max_abs, random_variables,
)

SIZE = 32
F32_LAYER_RTOL = 1e-5
F32_REL = 1e-3


@pytest.fixture(autouse=True)
def cpu_engine(monkeypatch):
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    # every feasible kernel site routes (to its plain version on the CPU)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    yield
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def variables():
    """A full (include_top) ResNet50 tree of numpy arrays."""
    return random_variables(jax_resnet.ResNet50(include_top=True),
                            (1, SIZE, SIZE, 3), seed=31)


@pytest.fixture(scope="module")
def modules(variables):
    """The port's ResNet50 with its head, and without (same weights)."""
    top = resnet.ResNet50(include_top=True)
    top.load_state_dict(from_flax_variables("ResNet50", variables))
    feat = resnet.ResNet50(include_top=False)
    feat.load_state_dict(from_flax_variables("ResNet50", headless(variables)))
    return top.eval(), feat.eval()


@pytest.fixture(scope="module")
def x32():
    """A batch on the caffe scale (BGR, mean-subtracted)."""
    return np.random.default_rng(32).uniform(
        -124.0, 152.0, size=(2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(variables, x32):
    """On ``x32``, one jit: the JAX module's features and probabilities,
    then the JAX ``resnet_fast_apply``'s (float32)."""
    top = jax_resnet.ResNet50(include_top=True)
    feat = jax_resnet.ResNet50(include_top=False, pooling="avg")

    def fn(vs, x):
        fast = [jax_resnet_fast_apply(v, x, include_top=t,
                                      compute_dtype=jnp.float32)
                for v, t in ((headless(vs), False), (vs, True))]
        return (feat.apply(headless(vs), x), top.apply(vs, x), *fast)

    return tuple(np.asarray(a) for a in jax.jit(fn)(variables, x32))


@pytest.mark.parametrize("cin,filters,stride,shortcut", [
    (256, 128, 2, True),   # conv3_block1: stride 2 on conv_0 and conv_1
    (512, 128, 1, False),  # an identity block
])
def test_residual_block_matches_flax(cin, filters, stride, shortcut):
    jm = jax_resnet.ResidualBlockV1(filters, stride=stride,
                                    conv_shortcut=shortcut)
    vs = random_variables(jm, (1, 9, 7, cin), seed=33)
    x = np.random.default_rng(34).normal(size=(2, 9, 7, cin)).astype(
        np.float32)
    ref = np.asarray(jm.apply(vs, x))
    tm = resnet.ResidualBlockV1(cin, filters, stride=stride,
                                conv_shortcut=shortcut)
    tm.load_state_dict(from_flax_variables("block", vs))
    with torch.inference_mode():
        ours = tm.eval()(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= F32_LAYER_RTOL * max(1.0, np.abs(ref).max())


def test_resnet50_matches_flax(modules, x32, reference):
    """All 16 blocks at full width, 32×32, batch 2, float32: features and
    softmax; no kernel of the port launches (none is on this path)."""
    kernels.reset_launches()
    with torch.inference_mode():
        feats = modules[1](torch.from_numpy(x32)).numpy()
        probs = modules[0](torch.from_numpy(x32)).numpy()
    assert not any(kernels.launches.values())
    assert feats.shape == (2, 2048) and probs.shape == (2, 1000)
    assert max_abs(feats, reference[0]) <= F32_REL * np.abs(
        reference[0]).max()
    assert max_abs(probs, reference[1]) <= F32_REL * np.abs(
        reference[1]).max()


@pytest.mark.parametrize("name", ["ResNet101", "ResNet152"])
def test_deeper_trees_map_one_to_one(name):
    """The full Flax tree (``jax.eval_shape`` of its init: no compile)
    carries to the port's module by a strict ``load_state_dict``, with
    every key and shape; weights are zeros broadcast from one cell."""
    jm = getattr(jax_resnet, name)(include_top=True)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    tree = jax.tree_util.tree_map(
        lambda sd: np.broadcast_to(np.float32(0), sd.shape),
        shapes)
    state = from_flax_variables(name, tree)
    module = getattr(resnet, name)(include_top=True)
    ours = module.state_dict()
    assert sorted(state) == sorted(ours)
    assert all(state[k].shape == ours[k].shape for k in ours)
    module.load_state_dict(state, strict=True)
    assert len(list(module.blocks())) == sum(module.stack_sizes) \
        == {"ResNet101": 33, "ResNet152": 50}[name]


@pytest.mark.parametrize("include_top", [False, True])
def test_fast_apply_matches_module_and_jax(modules, x32, reference,
                                           include_top):
    """``resnet_fast_apply`` (BN folded, each downsampling block's conv_0
    and conv_1 as one conv) against the port's module and against the
    JAX package's ``resnet_fast_apply``, float32."""
    module = modules[0] if include_top else modules[1]
    with torch.inference_mode():
        ours = resnet_fast_apply(module, torch.from_numpy(x32),
                                 include_top=include_top,
                                 compute_dtype=torch.float32).numpy()
    ref_module, ref_fast = reference[int(include_top)::2]
    assert ours.shape == ref_module.shape == ref_fast.shape
    assert max_abs(ours, ref_module) <= F32_REL * np.abs(ref_module).max()
    assert max_abs(ours, ref_fast) <= F32_REL * np.abs(ref_fast).max()


def test_registry_builds_resnets(variables):
    """Each ResNet name builds a featurizer and a predictor; the module
    path is the only one (the fast apply is not selected, as in the
    reference); the registry's spec carries the reference's figures."""
    for name in ("ResNet50", "ResNet101", "ResNet152"):
        spec, jspec = (registry.get_model_spec(name),
                       jax_registry.get_model_spec(name))
        assert (spec.input_size, spec.feature_dim, spec.classes,
                spec.flops_per_image, spec.featurize_kwargs) == (
            jspec.input_size, jspec.feature_dim, jspec.classes,
            jspec.flops_per_image, jspec.featurize_kwargs)
        assert spec.preprocess is registry.preprocess_caffe_mode
    feat = registry.build_featurizer("ResNet50", weights=variables)
    pred = registry.build_predictor("ResNet50", weights=variables)
    assert not feat.fast_path and not pred.fast_path
    assert isinstance(feat.variables, resnet.ResNet)
    assert not hasattr(feat.variables, "predictions")
    assert pred.variables.predictions.weight.shape == (1000, 2048)


@pytest.mark.parametrize("src", [(SIZE, SIZE), (40, 36)])
def test_bf16_flow(variables, src):
    """``with_dtype("bfloat16")`` in both packages over caffe-preprocessed
    ResNet50 at 32×32: without a resize the network runs in bf16; behind
    ``resized`` (whose cast brings the input back to the spec's float32)
    it runs in float32 with bf16-rounded weights — the reference's flow
    (ROADMAP Queue 3), reproduced, not fixed."""
    spec = (None, SIZE, SIZE, 3)
    jmf = JaxModelFunction.fromFlax(
        jax_resnet.ResNet50(include_top=False, pooling="avg"),
        headless(variables), JaxTensorSpec(spec), train=False
    ).with_preprocess(jax_registry.preprocess_caffe_mode)
    tmod = resnet.ResNet50(include_top=False)
    tmod.load_state_dict(from_flax_variables("ResNet50", headless(variables)))
    tmf = ModelFunction.fromModule(tmod, TensorSpec(spec)).with_preprocess(
        registry.preprocess_caffe_mode)
    x = np.random.default_rng(35).integers(0, 256, (2, *src, 3), np.uint8)
    ref = jmf.resized(src).with_dtype("bfloat16").apply_batch(x, batch_size=2)
    run = tmf.resized(src).with_dtype("bfloat16")
    seen = []
    run.variables.conv1_conv.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].dtype))
    ours = run.apply_batch(x, batch_size=2, device="cpu")
    assert seen == [torch.bfloat16 if src == (SIZE, SIZE) else torch.float32]
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (2, 2048)
    assert max_abs(ours, ref) <= BF16_TOLERANCE * max(1.0, np.abs(ref).max())


def test_featurizer_slice_matches_reference(variables):
    """``DeepImageFeaturizer(modelName="ResNet50")`` in both packages: two
    200×240 uint8 images, resized to 224×224 on the device, caffe-mode
    preprocessed, 2048-d features; float32."""
    rng = np.random.default_rng(36)
    images = [rng.integers(0, 256, size=(200, 240, 3), dtype=np.uint8)
              for _ in range(2)]
    jdf, tdf = frames(images, ["a", "b"])
    kw = dict(inputCol="image", outputCol="features", modelName="ResNet50",
              weights=headless(variables), batchSize=2)
    ref = column(sparkdl_tpu.DeepImageFeaturizer(**kw), jdf, "features")
    kernels.reset_launches()
    ours = column(sparkdl_tpu_torch.DeepImageFeaturizer(**kw), tdf,
                  "features")
    assert not any(kernels.launches.values())
    assert ours.shape == (2, 2048) and np.isfinite(ours).all()
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()
