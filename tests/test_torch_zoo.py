"""VGG, MobileNetV2 and TestNet in the port against the JAX package: the
shared layers (``pad2d``, ``correct_pad``), each model whole, VGG19's
tree, the registry (every Flax-native name builds, VGG featurizes at
fc2), each model's bf16 flow, TestNet's featurizer and predictor slices
and the label index.

Cost: numpy variables trees (``jax.eval_shape`` of the Flax init, filled
from numpy) at 32×32 (VGG16, TestNet) and at 32×32 and 33×35
(MobileNetV2: ``correct_pad`` adjusts both ways); batch 2; each JAX
reference is jitted once. One VGG16 featurizer runs at the registry's
224×224 on one image.

Tolerances:
- float32, one layer: max|Δ| = 0 for the pads, ≤ 1e-5·max(1, max|ref|)
  otherwise;
- float32, whole model or slice: max|Δ| ≤ 1e-3·max|ref|;
- bfloat16: max|Δ| ≤ 0.05 (``BF16_TOLERANCE``), relative to max(1,
  max|ref|) where the values are on the uint8 scale.
"""

import functools
import json

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
from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models import mobilenet as jax_mobilenet
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu.models import vgg as jax_vgg
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.ml import named_image
from sparkdl_tpu_torch.models import layers, mobilenet, registry, testnet, vgg
from sparkdl_tpu_torch.models.convert import from_flax_variables
from tests.torch_port_helpers import (
    column, frames, headless, max_abs, random_variables,
)

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


@pytest.mark.parametrize("shape", [(1, 6, 6, 2), (2, 7, 5, 3), (1, 1, 2, 4)])
@pytest.mark.parametrize("pad", [1, 3, ((0, 1), (2, 0))])
def test_pad2d_matches_jax(shape, pad):
    x = np.random.default_rng(40).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_layers.pad2d(jnp.asarray(x), pad))
    ours = layers.pad2d(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("hw", [(32, 32), (33, 35), (16, 7), (1, 2)])
@pytest.mark.parametrize("kernel", [3, 5])
def test_correct_pad_matches_jax(hw, kernel):
    x = np.zeros((1, *hw, 1), np.float32)
    assert layers.correct_pad(torch.from_numpy(x), kernel) \
        == jax_layers.correct_pad(jnp.asarray(x), kernel)


def _port(module, variables):
    module.load_state_dict(from_flax_variables("model", variables),
                           strict=True)
    return module.eval()


def _check_whole(ref, tm, variables, x, rel=F32_REL):
    """The port's ``tm`` on ``x`` against ``ref``, the JAX module's output
    (or the module itself, then jitted here)."""
    if not isinstance(ref, np.ndarray):
        ref = np.asarray(jax.jit(ref.apply)(variables, x))
    kernels.reset_launches()
    with torch.inference_mode():
        ours = _port(tm, variables)(torch.from_numpy(x)).numpy()
    assert not any(kernels.launches.values())
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= rel * np.abs(ref).max()
    return ours


@pytest.fixture(scope="module")
def vgg16_variables():
    """A full (include_top) VGG16 tree of numpy arrays, at 32×32."""
    return random_variables(jax_vgg.VGG16(include_top=True), (1, 32, 32, 3),
                            seed=41)


@pytest.fixture(scope="module")
def vgg16_reference(vgg16_variables):
    """A batch on the caffe scale, and the JAX module's fc2 features (from
    the head-less tree) and softmax on it, one jit."""
    x = np.random.default_rng(42).uniform(-124.0, 152.0, (2, 32, 32, 3)
                                          ).astype(np.float32)
    fc2 = jax_vgg.VGG16(include_top=True, features_at_fc2=True)
    top = jax_vgg.VGG16(include_top=True)
    fn = jax.jit(lambda vs, x: (fc2.apply(headless(vs), x),
                                top.apply(vs, x)))
    return x, tuple(np.asarray(a) for a in fn(vgg16_variables, x))


@pytest.mark.parametrize("fc2", [True, False])
def test_vgg16_matches_flax(vgg16_variables, vgg16_reference, fc2):
    """All 13 convs and the dense head at 32×32 (the flatten in NHWC
    order), float32: fc2's features without a ``predictions`` layer, or
    the softmax with it."""
    x, refs = vgg16_reference
    vs = headless(vgg16_variables) if fc2 else vgg16_variables
    tm = vgg.VGG16(include_top=True, features_at_fc2=fc2, input_size=(32, 32))
    assert hasattr(tm, "predictions") is not fc2
    ours = _check_whole(refs[0] if fc2 else refs[1], tm, vs, x)
    assert ours.shape == ((2, 4096) if fc2 else (2, 1000))


def test_vgg_flattens_in_nhwc_order():
    """At 64×64 the flatten sees 2×2×512 cells: the port's order is the
    reference's, so ``fc1`` reads the same weights rows."""
    jm = jax_vgg.VGG(convs_per_block=(1, 1, 1, 1, 1), include_top=True,
                     features_at_fc2=True)
    vs = random_variables(jm, (1, 64, 64, 3), seed=43)
    x = np.random.default_rng(44).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    tm = vgg.VGG(convs_per_block=(1, 1, 1, 1, 1), include_top=True,
                 features_at_fc2=True, input_size=(64, 64))
    _check_whole(jm, tm, vs, x)


@functools.lru_cache(maxsize=None)
def _mobilenet_tree(hw):
    """A full MobileNetV2 tree of numpy arrays at ``hw``, made once."""
    return random_variables(jax_mobilenet.MobileNetV2(include_top=True),
                            (1, *hw, 3), seed=45)


@pytest.mark.parametrize("hw,include_top", [((32, 32), True),
                                             ((33, 35), False)], ids=str)
def test_mobilenet_v2_matches_flax(hw, include_top):
    """All 17 inverted residual blocks at full width, float32: the softmax
    at 32×32, where ``correct_pad`` pads (0, 1) before each stride-2
    depthwise, and the features at 33×35, where it pads (1, 1)."""
    vs = _mobilenet_tree(hw)
    vs = vs if include_top else headless(vs)
    x = np.random.default_rng(46).uniform(-1.0, 1.0, (2, *hw, 3)).astype(
        np.float32)
    ours = _check_whole(jax_mobilenet.MobileNetV2(include_top=include_top),
                        mobilenet.MobileNetV2(include_top=include_top), vs, x)
    assert ours.shape == ((2, 1000) if include_top else (2, 1280))


@pytest.mark.parametrize("expansion,stride,cin,filters", [
    (1, 1, 32, 16), (6, 2, 16, 24), (6, 1, 24, 24)])
def test_inverted_res_block_matches_flax(expansion, stride, cin, filters):
    """One block, float32: block 0's (no expand), a stride-2 one (no
    residual) and one with the residual."""
    block_id = 0 if expansion == 1 else 1
    jm = jax_mobilenet.InvertedResBlock(filters, stride, expansion,
                                        block_id=block_id)
    vs = random_variables(jm, (1, 9, 8, cin), seed=47)
    x = np.random.default_rng(48).normal(size=(2, 9, 8, cin)).astype(
        np.float32)
    ref = np.asarray(jm.apply(vs, x))
    tm = _port(mobilenet.InvertedResBlock(cin, filters, stride, expansion,
                                          block_id=block_id), vs)
    assert tm.residual is (cin == filters and stride == 1)
    with torch.inference_mode():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("include_top", [True, False])
def test_testnet_matches_flax(include_top):
    jm = jax_testnet.TestNet(include_top=include_top)
    vs = random_variables(jm, (1, 32, 32, 3), seed=49)
    x = np.random.default_rng(50).uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(
        np.float32)
    ours = _check_whole(jm, testnet.TestNet(include_top=include_top), vs, x)
    assert ours.shape == ((2, 10) if include_top else (2, 16))


@pytest.mark.parametrize("name,fc2", [("VGG19", True),
                                      ("MobileNetV2", False)])
def test_trees_map_one_to_one(name, fc2):
    """The full Flax tree at the registry's 224×224 (``jax.eval_shape`` of
    its init: no compile) carries to the port's module by a strict
    ``load_state_dict``, with every key and shape."""
    spec = jax_registry.get_model_spec(name)
    kwargs = ({"include_top": True, "features_at_fc2": fc2}
              if name.startswith("VGG") else {"include_top": True})
    jm = spec.builder(**kwargs)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    tree = jax.tree_util.tree_map(
        lambda sd: np.broadcast_to(np.float32(0), sd.shape), shapes)
    state = from_flax_variables(name, tree)
    module = registry.get_model_spec(name).builder(**kwargs)
    ours = module.state_dict()
    assert sorted(state) == sorted(ours)
    assert all(state[k].shape == ours[k].shape for k in ours)
    module.load_state_dict(state, strict=True)


def test_registry_serves_every_flax_native_name():
    """Every Flax-native name of the reference's registry builds a
    featurizer and a predictor with the reference's spec; its ingested
    names still raise ``NotImplementedError``."""
    native = sorted(jax_registry.SUPPORTED_MODELS)
    assert registry.SUPPORTED_MODEL_NAMES == native
    assert sorted(registry.REFERENCE_MODEL_NAMES) == sorted(
        jax_registry.SUPPORTED_MODEL_NAMES)
    for name in native:
        spec, jspec = (registry.get_model_spec(name),
                       jax_registry.get_model_spec(name))
        assert (spec.input_size, spec.feature_dim, spec.classes,
                spec.flops_per_image, spec.featurize_kwargs) == (
            jspec.input_size, jspec.feature_dim, jspec.classes,
            jspec.flops_per_image, jspec.featurize_kwargs), name
        mode = next(k for k, f in jax_registry.PREPROCESS_MODES.items()
                    if f is jspec.preprocess)
        assert spec.preprocess is registry.PREPROCESS_MODES[mode], name
    for name in jax_registry._INGESTED_MODELS:
        with pytest.raises(NotImplementedError):
            registry.build_featurizer(name)
    for name in ("TestNet", "MobileNetV2"):
        x = np.random.default_rng(51).integers(
            0, 256, (1, *registry.get_model_spec(name).input_size, 3),
            np.uint8)
        feats = registry.build_featurizer(name).apply_batch(
            x, batch_size=1, device="cpu")
        probs = registry.build_predictor(name).apply_batch(
            x, batch_size=1, device="cpu")
        spec = registry.get_model_spec(name)
        assert feats.shape == (1, spec.feature_dim)
        assert probs.shape == (1, spec.classes)
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def test_vgg_featurizer_from_headless_tree():
    """``build_featurizer("VGG16")`` at 224×224 takes the head-less part of
    the full Flax tree (no ``predictions``) by a strict load and emits
    fc2's 4096 features (parity at 32×32 is held above). Each leaf is one
    small constant broadcast to its shape: no random fill of 134M
    weights."""
    jm = jax_vgg.VGG16(include_top=True)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    tree = headless({"params": jax.tree_util.tree_map(
        lambda sd: np.broadcast_to(np.float32(
            1.0 / np.prod(sd.shape[:-1]) if len(sd.shape) > 1 else 0.01),
            sd.shape), shapes["params"])})
    mf = registry.build_featurizer("VGG16", weights=tree)
    assert not hasattr(mf.variables, "predictions")
    x = np.random.default_rng(52).integers(0, 256, (1, 224, 224, 3),
                                           np.uint8)
    feats = mf.apply_batch(x, batch_size=1, device="cpu")
    assert feats.shape == (1, 4096) and np.isfinite(feats).all()
    assert feats.min() > 0


@pytest.mark.parametrize("name", ["VGG16", "MobileNetV2", "TestNet"])
@pytest.mark.parametrize("resize", [False, True])
def test_bf16_flow(request, name, resize):
    """``with_dtype("bfloat16")`` in both packages over each model's
    featurizer at 32×32 with its registry preprocess: without a resize
    the network runs in bf16; behind ``resized`` (whose cast brings the
    input back to the spec's float32) it runs in float32 with
    bf16-rounded weights — the reference's flow (ROADMAP Queue 3),
    reproduced, not fixed."""
    vs = headless(_mobilenet_tree((32, 32)) if name == "MobileNetV2" else
                  request.getfixturevalue({"VGG16": "vgg16_variables",
                                           "TestNet": "testnet_variables"}
                                          [name]))
    jspec, spec = (jax_registry.get_model_spec(name),
                   registry.get_model_spec(name))
    kwargs = dict(jspec.featurize_kwargs or {"include_top": False,
                                             "pooling": "avg"})
    jm = jspec.builder(**kwargs)
    if name == "VGG16":
        kwargs["input_size"] = (32, 32)
    tm = _port(spec.builder(**kwargs), vs)
    shape = (None, 32, 32, 3)
    jmf = JaxModelFunction.fromFlax(jm, vs, JaxTensorSpec(shape),
                                    train=False).with_preprocess(
        jspec.preprocess)
    tmf = ModelFunction.fromModule(tm, TensorSpec(shape)).with_preprocess(
        spec.preprocess)
    src = (39, 35) if resize else (32, 32)
    x = np.random.default_rng(54).integers(0, 256, (2, *src, 3), np.uint8)
    ref = jmf.resized(src).with_dtype("bfloat16").apply_batch(x, batch_size=2)
    run = tmf.resized(src).with_dtype("bfloat16")
    first = next(m for m in run.variables.modules()
                 if isinstance(m, layers.Conv2d))
    seen = []
    first.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    ours = run.apply_batch(x, batch_size=2, device="cpu")
    assert seen == [torch.float32 if resize else torch.bfloat16]
    assert ours.dtype == np.float32 and ours.shape == ref.shape \
        == (2, spec.feature_dim)
    assert max_abs(ours, ref) <= BF16_TOLERANCE * max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def testnet_variables():
    return random_variables(jax_testnet.TestNet(include_top=True),
                            (1, 32, 32, 3), seed=55)


@pytest.fixture(scope="module")
def testnet_frames():
    """Two 40×36 uint8 images (resized to 32×32 on the device)."""
    rng = np.random.default_rng(56)
    images = [rng.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
              for _ in range(2)]
    return frames(images, ["a", "b"])


def test_testnet_featurizer_slice(testnet_variables, testnet_frames):
    jdf, tdf = testnet_frames
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              weights=headless(testnet_variables), batchSize=2)
    ref = column(sparkdl_tpu.DeepImageFeaturizer(**kw), jdf, "features")
    ours = column(sparkdl_tpu_torch.DeepImageFeaturizer(**kw), tdf,
                  "features")
    assert ours.shape == (2, 16) and np.isfinite(ours).all()
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()


def test_testnet_predictor_slice(testnet_variables, testnet_frames):
    """Probabilities over TestNet's 10 classes, and their top-5 decoded
    over those classes, in both packages."""
    jdf, tdf = testnet_frames
    kw = dict(inputCol="image", outputCol="probs", modelName="TestNet",
              weights=testnet_variables, batchSize=2)
    ref = column(sparkdl_tpu.DeepImagePredictor(**kw), jdf, "probs")
    ours = column(sparkdl_tpu_torch.DeepImagePredictor(**kw), tdf, "probs")
    assert ours.shape == (2, 10)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-5)
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()
    kw.update(decodePredictions=True, topK=5)
    jrows = sparkdl_tpu.DeepImagePredictor(**kw).transform(jdf).collect()
    trows = sparkdl_tpu_torch.DeepImagePredictor(**kw).transform(
        tdf).collect()
    for jrow, trow, probs in zip(jrows, trows, ours):
        assert [d["class"] for d in trow["probs"]] \
            == [d["class"] for d in jrow["probs"]] \
            == [f"class_{i}" for i in np.argsort(-probs, kind="stable")[:5]]
        assert max_abs([d["probability"] for d in trow["probs"]],
                       [d["probability"] for d in jrow["probs"]]) \
            <= F32_REL * float(probs.max())


def test_imagenet_labels_read_the_keras_index(tmp_path, monkeypatch):
    """Without a class index the labels are ``class_<i>``; with one under
    ``~/.keras/models/`` (first) or ``~/.keras/`` they are its entries,
    in both packages."""
    from sparkdl_tpu.ml import named_image as jax_named_image

    monkeypatch.setenv("HOME", str(tmp_path))
    assert named_image.imagenet_labels(3) == [
        (f"class_{i}", f"class_{i}") for i in range(3)]
    index = {str(i): [f"n{i:08d}", f"thing_{i}"] for i in range(12)}
    (tmp_path / ".keras").mkdir()
    (tmp_path / ".keras" / "imagenet_class_index.json").write_text(
        json.dumps(index))
    assert named_image.imagenet_labels(10) == [
        (f"n{i:08d}", f"thing_{i}") for i in range(10)]
    (tmp_path / ".keras" / "models").mkdir()
    (tmp_path / ".keras" / "models" / "imagenet_class_index.json").write_text(
        json.dumps({k: [v[0], v[1].upper()] for k, v in index.items()}))
    assert named_image.imagenet_labels(2) == [("n00000000", "THING_0"),
                                              ("n00000001", "THING_1")]
    for n in (2, 10, 12, 13):
        assert named_image.imagenet_labels(n) \
            == jax_named_image.imagenet_labels(n)
