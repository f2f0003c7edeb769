"""InceptionV3 in the port against the JAX package: its layers, the module
path (``fast=False``, with the ``pw1x1`` route), the fast path, the
registry and the featurizer slice.

Cost: one InceptionV3 variables tree per module (``jax.eval_shape`` of the
Flax init, filled from numpy) at 75×75, the model's smallest input, which
still runs all 94 units at full width; batch 2; every JAX reference is
jitted once.

Tolerances:
- float32, one layer: max|Δ| ≤ 1e-5·max(1, max|ref|) (sums reassociate);
- float32, whole model or slice: max|Δ| ≤ 1e-3·max|ref| (94 conv layers
  of reassociated sums, the pw1x1 route's folded BN against the
  reference's unfolded BN);
- bfloat16: max|Δ| ≤ 0.05 (``BF16_TOLERANCE``), relative to max(1,
  max|ref|) where the values are on the uint8 scale.
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
from sparkdl_tpu.models import inception_fast as jax_inception_fast
from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models.inception import InceptionV3 as JaxInceptionV3
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import inception_fast, layers, registry
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.inception import InceptionV3
from tests.torch_port_helpers import (
    column, frames, headless, max_abs, random_variables,
)

SIZE = 75
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
    """A full (include_top) InceptionV3 tree of numpy arrays."""
    return random_variables(JaxInceptionV3(include_top=True),
                            (1, SIZE, SIZE, 3), seed=21)


@pytest.fixture(scope="module")
def modules(variables):
    """The port's InceptionV3 with its head, and without (same weights)."""
    top = InceptionV3(include_top=True)
    top.load_state_dict(from_flax_variables("InceptionV3", variables))
    feat = InceptionV3(include_top=False)
    feat.load_state_dict(from_flax_variables("InceptionV3",
                                             headless(variables)))
    return top.eval(), feat.eval()


@pytest.fixture(scope="module")
def x75():
    """A preprocessed batch: [-1, 1] floats."""
    return np.random.default_rng(22).uniform(
        -1.0, 1.0, size=(2, SIZE, SIZE, 3)).astype(np.float32)


def _layer_bound(ref) -> float:
    return F32_LAYER_RTOL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("kernel,strides,padding,act,routed", [
    ((1, 1), (1, 1), "SAME", True, True),
    ((1, 1), (1, 1), "SAME", False, True),
    ((1, 1), (1, 1), "VALID", True, False),  # the stem's cb3: never routed
    ((3, 3), (1, 1), "SAME", True, False),
    ((1, 7), (1, 1), "SAME", True, False),
    ((3, 3), (2, 2), "VALID", True, False),
])
def test_conv_bn_matches_flax(kernel, strides, padding, act, routed):
    cin, cout = 12, 20
    jm = jax_layers.ConvBN(cout, kernel, strides=strides, padding=padding,
                           act=act, kernel_family="inception")
    vs = random_variables(jm, (1, 9, 11, cin), seed=23)
    x = np.random.default_rng(24).normal(size=(2, 9, 11, cin)).astype(
        np.float32)
    ref = np.asarray(jm.apply(vs, x))
    tm = layers.ConvBN(cin, cout, kernel, strides, padding, act=act,
                       kernel_family="inception")
    tm.load_state_dict(from_flax_variables("ConvBN", vs))
    tm.eval()
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        assert (tm._fused(xt) is not None) == routed
        ours = tm(xt).numpy()
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= _layer_bound(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pools_match_flax(dtype):
    """``avg_pool_same`` divides by the valid cells at the image edges;
    VALID ``max_pool`` is exact."""
    x = np.random.default_rng(25).normal(size=(2, 7, 6, 5)).astype(
        np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jax_layers.avg_pool_same(xj).astype(jnp.float32))
    ours = layers.avg_pool_same(xt).float().numpy()
    assert ours.shape == ref.shape
    bound = _layer_bound(ref) if dtype == "float32" else BF16_TOLERANCE
    assert max_abs(ours, ref) <= bound
    np.testing.assert_array_equal(
        layers.max_pool(xt, 3, 2).float().numpy(),
        np.asarray(jax_layers.max_pool(xj, 3, 2).astype(jnp.float32)))


def test_flax_tree_maps_one_to_one(variables):
    """Every leaf of the full Flax tree, ``predictions`` included, has one
    entry of the port's state dict, and nothing else is there."""
    state = from_flax_variables("InceptionV3", variables)
    assert set(state) == set(InceptionV3(include_top=True).state_dict())
    assert len(state) == 94 * 4 + 2   # conv, BN β, mean, var; Dense


def test_module_path_matches_flax(variables, modules, x75):
    """Features and softmax of the module path (39 units through the
    pw1x1 route, its plain version on the CPU) against the Flax module."""
    top, feat = modules
    ref_probs = np.asarray(jax.jit(JaxInceptionV3(include_top=True).apply)(
        variables, x75))
    ref_feats = np.asarray(jax.jit(JaxInceptionV3(include_top=False).apply)(
        headless(variables), x75))
    kernels.reset_launches()
    with torch.inference_mode():
        probs = top(torch.from_numpy(x75)).numpy()
        feats = feat(torch.from_numpy(x75)).numpy()
    assert not any(kernels.launches.values())  # CPU: plain versions only
    assert feats.shape == (2, 2048) and probs.shape == (2, 1000)
    assert max_abs(feats, ref_feats) <= F32_REL * np.abs(ref_feats).max()
    assert max_abs(probs, ref_probs) <= F32_REL * np.abs(ref_probs).max()


def test_module_path_routes_every_eligible_unit(modules, x75, monkeypatch):
    calls = []
    route = kernels.route_pw1x1
    monkeypatch.setattr(kernels, "route_pw1x1",
                        lambda *a, **k: calls.append(a[0].shape) or
                        route(*a, **k))
    with torch.inference_mode():
        modules[1](torch.from_numpy(x75))
    assert len(calls) == 39


@pytest.mark.parametrize("include_top", [False, True])
def test_fast_path_matches_jax(variables, modules, x75, include_top):
    vs = variables if include_top else headless(variables)
    ref = np.asarray(jax.jit(
        lambda v, x: jax_inception_fast.inception_v3_fast_apply(
            v, x, include_top=include_top, compute_dtype=jnp.float32))(
        vs, x75))
    module = modules[0] if include_top else modules[1]
    with torch.inference_mode():
        ours = inception_fast.inception_v3_fast_apply(
            module, torch.from_numpy(x75), include_top=include_top,
            compute_dtype=torch.float32).numpy()
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()


def test_registry_builds_both_paths(variables):
    """``fast`` picks the path and sets ``fast_path``; both take the full
    tree (the featurizer its head-less part), and agree."""
    x = np.random.default_rng(26).integers(0, 256, (2, SIZE, SIZE, 3),
                                           np.uint8)
    out = {}
    for fast in (True, False):
        feat = registry.build_featurizer("InceptionV3", weights=variables,
                                         fast=fast)
        pred = registry.build_predictor("InceptionV3", weights=variables,
                                        fast=fast)
        assert feat.fast_path is fast and pred.fast_path is fast
        out[fast] = (feat.apply_batch(x, batch_size=2, device="cpu"),
                     pred.apply_batch(x, batch_size=2, device="cpu"))
    for a, b in zip(out[True], out[False]):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert max_abs(a, b) <= F32_REL * np.abs(b).max()
    np.testing.assert_allclose(out[True][1].sum(axis=1), 1.0, rtol=1e-5)
    bf16 = registry.build_featurizer("InceptionV3", weights=variables,
                                     dtype="bfloat16").apply_batch(
        x, batch_size=2, device="cpu")
    assert bf16.dtype == np.float32
    assert max_abs(bf16, out[True][0]) <= BF16_TOLERANCE * max(
        1.0, np.abs(out[True][0]).max())


def test_fast_path_bf16_flow(variables, modules, monkeypatch):
    """Under ``with_dtype("bfloat16")`` at the model's own size the input
    is cast to bf16 and scaled in bf16, then the fast apply casts it back
    to its float32 compute dtype: its convs see float32 input with
    bf16-rounded weights, in the reference as in the port."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jax_inception_fast), ("torch", inception_fast)):
        conv = mod._conv
        monkeypatch.setattr(mod, "_conv", lambda x, *a, _c=conv, _k=key,
                            **kw: seen[_k].append(str(x.dtype)) or
                            _c(x, *a, **kw))
    jmf = JaxModelFunction.fromFunction(
        jax_registry._fast_inference_apply("InceptionV3", False, None),
        headless(variables), JaxTensorSpec((None, SIZE, SIZE, 3)))
    tmf = ModelFunction.fromFunction(
        registry._fast_inference_apply("InceptionV3", False, None),
        modules[1], TensorSpec((None, SIZE, SIZE, 3)))
    x = np.random.default_rng(27).integers(0, 256, (2, SIZE, SIZE, 3),
                                           np.uint8)
    ref = jmf.with_preprocess(jax_registry.preprocess_tf_mode).with_dtype(
        "bfloat16").apply_batch(x, batch_size=2)
    ours = tmf.with_preprocess(registry.preprocess_tf_mode).with_dtype(
        "bfloat16").apply_batch(x, batch_size=2, device="cpu")
    assert set(seen["jax"]) == {"float32"}
    assert set(seen["torch"]) == {"torch.float32"}
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (2, 2048)
    assert max_abs(ours, ref) <= BF16_TOLERANCE * max(1.0,
                                                      np.abs(ref).max())


def test_featurizer_slice_matches_reference(variables):
    """``DeepImageFeaturizer(modelName="InceptionV3")`` in both packages:
    two 40×48 uint8 images, resized to 299×299 on the device, tf-mode
    scaled, the fast path, 2048-d features; float32."""
    rng = np.random.default_rng(28)
    images = [rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
              for _ in range(2)]
    jdf, tdf = frames(images, ["a", "b"])
    kw = dict(inputCol="image", outputCol="features",
              modelName="InceptionV3", weights=headless(variables),
              batchSize=2)
    ref = column(sparkdl_tpu.DeepImageFeaturizer(**kw), jdf, "features")
    featurizer = sparkdl_tpu_torch.DeepImageFeaturizer(**kw)
    kernels.reset_launches()
    ours = column(featurizer, tdf, "features")
    assert featurizer._model_function("featurize").fast_path
    assert ours.shape == (2, 2048) and np.isfinite(ours).all()
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()
    assert not any(kernels.launches.values())
