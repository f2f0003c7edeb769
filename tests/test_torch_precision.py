"""int8 weight-only post-training quantization in the port against the JAX
package's ``with_dtype("int8")``, on the CPU.

Models (small): TestNet; a two-block Xception (block 1's stem conv and BN,
block 2's residual conv and its pair of ``SeparableConvBN`` units, a dense
head); InceptionV3's fast path over a tree of every width divided by 8.
Weights are numpy, shaped by the Flax module's tree, and cross to the
port through ``from_flax_variables``; inputs are numpy from a seed.

What is held:
- the int8 ``q`` and float32 ``scale`` of every kernel equal the
  reference's leaves bit for bit after the layout change (HWIO → OIHW,
  dense ``(in, out)`` → ``(out, in)``), and so do the dequantized bf16
  weights; every other float tensor is the reference's value in bf16;
- outputs, float32, within the bf16 tolerance ``0.05·max|ref|`` of the
  reference's int8 outputs, with and without a resize;
- ``weight_bytes``, ``kernel_routable``, one memoized variant across
  threads, and the knob through ``EngineConfig`` and ``executor.execute``.

The port holds the non-kernel floats (BN statistics, biases) in bf16,
where the reference holds them in float32 and casts them at each forward:
the same values reach the layers, and its ``weight_bytes`` is the
reference's less 2 bytes for each of their elements.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sparkdl_tpu.core import executor as jax_executor
from sparkdl_tpu.core import model_function as jax_mfn
from sparkdl_tpu.core.kernels import BF16_TOLERANCE
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import inception as jax_inception
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu.models.layers import KERAS_BN_EPS
from sparkdl_tpu.models.layers import SeparableConvBN as JaxSeparableConvBN
from sparkdl_tpu_torch.core import executor, kernels
from sparkdl_tpu_torch.core import model_function as mfn
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import layers, registry
from sparkdl_tpu_torch.models.convert import from_flax_variables
from tests.torch_port_helpers import headless, max_abs, random_variables


@pytest.fixture(autouse=True)
def cpu_engine(monkeypatch):
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    # every feasible kernel site routes (to its plain version on the CPU)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    executor.reset()
    yield
    executor.reset()
    EngineConfig.restore(saved)


# -- the models ---------------------------------------------------------------


class JaxTwoBlock(fnn.Module):
    """Xception's block 1 (one conv and BN) and block 2 (a strided 1×1
    residual conv, two separable units, a SAME max pool), then a dense
    head, in the reference's layers."""

    @fnn.compact
    def __call__(self, x):
        def bn(name):
            return fnn.BatchNorm(use_running_average=True,
                                 epsilon=KERAS_BN_EPS, momentum=0.99,
                                 name=name)

        x = fnn.Conv(8, (3, 3), strides=(2, 2), padding="VALID",
                     use_bias=False, name="block1_conv1")(x)
        x = fnn.relu(bn("block1_conv1_bn")(x))
        residual = bn("block2_res_bn")(fnn.Conv(
            16, (1, 1), strides=(2, 2), padding="SAME", use_bias=False,
            name="block2_res_conv")(x))
        x = JaxSeparableConvBN(16, name="block2_sepconv1")(x)
        x = fnn.relu(x)
        x = JaxSeparableConvBN(16, name="block2_sepconv2")(x)
        x = fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME") + residual
        return fnn.Dense(10, name="predictions")(jnp.mean(x, axis=(1, 2)))


class TwoBlock(nn.Module):
    """:class:`JaxTwoBlock` in the port's layers, its units routed to
    ``sep2d`` as Xception's are."""

    def __init__(self):
        super().__init__()
        self.block1_conv1 = layers.Conv2d(3, 8, 3, stride=2,
                                          padding="VALID")
        self.block1_conv1_bn = layers.BatchNorm(8)
        self.block2_res_conv = layers.Conv2d(8, 16, 1, stride=2)
        self.block2_res_bn = layers.BatchNorm(16)
        self.block2_sepconv1 = layers.SeparableConvBN(
            8, 16, kernel_family="xception")
        self.block2_sepconv2 = layers.SeparableConvBN(
            16, 16, kernel_family="xception")
        self.predictions = layers.Dense(16, 10)

    def forward(self, x):
        x = torch.relu(self.block1_conv1_bn(self.block1_conv1(x)))
        residual = self.block2_res_bn(self.block2_res_conv(x))
        x = torch.relu(self.block2_sepconv1(x))
        x = self.block2_sepconv2(x)
        x = layers.max_pool_same(x, 3, 2) + residual
        return self.predictions(layers.global_avg_pool(x))


def _narrow(shapes, factor: int = 8):
    """An InceptionV3 tree's shapes with every channel count divided by
    ``factor`` (the stem's 3 input channels kept): each unit's input is
    still the concatenation of the narrowed branches before it."""
    def narrow(path, sd):
        shape = list(sd.shape)
        if path[-1].key == "kernel":
            if shape[2] != 3:
                shape[2] //= factor
            shape[3] //= factor
        else:
            shape[0] //= factor
        return jax.ShapeDtypeStruct(tuple(shape), sd.dtype)

    return jax.tree_util.tree_map_with_path(narrow, shapes)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        leaf, shape = path[-1].key, sd.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf == "bias" or leaf == "mean":
            return (rng.normal(size=shape) * 0.1).astype(np.float32)
        return (np.abs(rng.normal(size=shape)) + 1.0).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, _plain(tree))


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _units_of(tree):
    """The port's module for an InceptionV3 fast-path tree: one
    ``ConvBN`` named ``cb<i>`` per unit, of the tree's widths."""
    module = nn.Module()
    for name, unit in tree["params"].items():
        kh, kw, cin, cout = unit["conv"]["kernel"].shape
        module.add_module(name, layers.ConvBN(cin, cout, (kh, kw)))
    module.load_state_dict(from_flax_variables("InceptionV3", tree))
    return module.eval()


def _inception_pair():
    shapes = jax.eval_shape(lambda: jax_inception.InceptionV3(
        include_top=False).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 75, 75, 3), jnp.float32)))
    tree = _fill(_narrow(_plain(shapes)), seed=41)
    spec = (None, 75, 75, 3)
    jmf = JaxModelFunction.fromFunction(
        jax_registry._fast_inference_apply("InceptionV3", False, None),
        tree, JaxTensorSpec(spec)).with_preprocess(
            jax_registry.preprocess_tf_mode)
    tmf = ModelFunction.fromFunction(
        registry._fast_inference_apply("InceptionV3", False, None),
        _units_of(tree), TensorSpec(spec)).with_preprocess(
            registry.preprocess_tf_mode)
    return jmf, tmf, tree


def _pair(name):
    """(the reference's ModelFunction, the port's, the Flax tree) of one
    model, float32, same weights."""
    if name == "inception_fast":
        return _inception_pair()
    if name == "testnet":
        vs = headless(random_variables(jax_testnet.TestNet(include_top=True),
                                       (1, 32, 32, 3), seed=31))
        return (jax_registry.build_featurizer("TestNet", weights=vs),
                registry.build_featurizer("TestNet", weights=vs), vs)
    vs = random_variables(JaxTwoBlock(), (1, 19, 19, 3), seed=32)
    spec = (None, 19, 19, 3)
    module = TwoBlock()
    module.load_state_dict(from_flax_variables("two_block", vs))
    return (JaxModelFunction.fromFlax(JaxTwoBlock(), vs, JaxTensorSpec(spec)),
            ModelFunction.fromModule(module, TensorSpec(spec)), vs)


MODELS = ["testnet", "xception_two_block", "inception_fast"]


@pytest.fixture(scope="module")
def pairs():
    return {}


def _get(pairs, name):
    if name not in pairs:
        pairs[name] = _pair(name)
    return pairs[name]


def _flat(tree, path=()):
    """(path, leaf) of a reference tree, a quantized leaf as one leaf."""
    if isinstance(tree, dict) and not jax_mfn._is_q8_leaf(tree):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _torch_layout(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- quantized weights --------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_int8_leaves_equal_reference_bit_for_bit(pairs, name):
    """Every kernel's ``q`` and ``scale``, and its dequantized bf16
    weight, equal the reference's after the layout change; every other
    float tensor is the reference's value rounded to bf16."""
    jmf, tmf, _ = _get(pairs, name)
    ref = jmf.with_dtype("int8").variables
    deq = jax.jit(jax_mfn._dequantize_tree)(ref)  # as inside its program
    module = tmf.with_dtype("int8").variables
    state = module.state_dict()
    quantized = 0
    for path, leaf in _flat(ref):
        coll, *mod, leaf_name = path
        key = ".".join(mod)
        ref_deq = np.asarray(
            _dequant_leaf(deq, path).astype(jnp.float32))
        if jax_mfn._is_q8_leaf(leaf):
            q = np.asarray(leaf[jax_mfn._Q8_WEIGHTS])
            scale = np.asarray(leaf[jax_mfn._Q8_SCALE])
            assert leaf_name == "kernel"
            assert np.array_equal(state[f"{key}.weight_q8"].numpy(),
                                  _torch_layout(q))
            assert state[f"{key}.weight_q8"].dtype == torch.int8
            assert np.array_equal(state[f"{key}.weight_q8_scale"].numpy(),
                                  scale)
            assert np.array_equal(
                _bits(module.get_submodule(key).weight),
                _torch_layout(ref_deq))
            quantized += 1
            continue
        port_name = {"scale": "weight", "bias": "bias", "mean":
                     "running_mean", "var": "running_var"}[leaf_name]
        ours = state[f"{key}.{port_name}"]
        assert ours.dtype == torch.bfloat16
        assert np.array_equal(_bits(ours), ref_deq)
    assert quantized == len(mfn._kernel_layers(tmf.variables)) > 0
    assert not list(module.parameters()) or all(
        p.dtype == torch.bfloat16 for p in module.parameters())


def _dequant_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_plain_tree_quantizes_per_last_axis_as_reference():
    """A ``fromFunction`` model over a plain tensor follows the
    reference's rule literally: the last axis (the reference's
    ``tests/core/test_precision.py`` model)."""
    w = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(3,)).astype(np.float32)
    jmf = JaxModelFunction(lambda vs, x: jnp.tanh(x @ vs["w"] + vs["b"]),
                           {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           JaxTensorSpec((None, 6)), name="prec")
    tmf = ModelFunction(lambda vs, x: torch.tanh(x @ vs["w"] + vs["b"]),
                        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        TensorSpec((None, 6)), name="prec")
    ref, ours = jmf.with_dtype("int8"), tmf.with_dtype("int8")
    leaf = ours.variables["w"]
    assert mfn._is_q8_leaf(leaf)
    assert leaf[mfn._Q8_SCALE].shape == (3,)
    assert np.array_equal(leaf[mfn._Q8_WEIGHTS].numpy(),
                          np.asarray(ref.variables["w"][jax_mfn._Q8_WEIGHTS]))
    assert np.array_equal(leaf[mfn._Q8_SCALE].numpy(),
                          np.asarray(ref.variables["w"][jax_mfn._Q8_SCALE]))
    assert ours.variables["b"].dtype == torch.float32  # cast per forward
    assert ours.weight_bytes() == ref.weight_bytes() == 6 * 3 + 3 * 4 + 3 * 4
    x = np.random.default_rng(2).normal(size=(9, 6)).astype(np.float32)
    got = ours.apply_batch(x, batch_size=16, device="cpu")
    want = ref.apply_batch(x, batch_size=16)
    assert got.dtype == np.float32
    assert max_abs(got, want) <= BF16_TOLERANCE * np.abs(want).max()


def test_with_dtype_contract():
    tmf = ModelFunction.fromModule(TwoBlock(), TensorSpec((None, 19, 19, 3)))
    assert tmf.with_dtype("float32") is tmf
    assert tmf.with_dtype("int8") is tmf.with_dtype("int8")
    assert tmf.with_dtype("int8") is not tmf.with_dtype("bfloat16")
    with pytest.raises(ValueError, match="precision"):
        tmf.with_dtype("float16")
    assert mfn.PRECISIONS == jax_mfn.PRECISIONS


# -- outputs ------------------------------------------------------------------


def _inputs(name, src, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(2, *src, 3)).astype(np.uint8)


SIZES = {"testnet": ((32, 32), (40, 36)),
         "xception_two_block": ((19, 19), (23, 21)),
         "inception_fast": ((75, 75), (60, 64))}


@pytest.mark.parametrize("resize", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_int8_outputs_match_reference(pairs, name, resize):
    """float32 outputs within ``0.05·max|ref|`` of the reference's int8
    run, through ``resized`` or not. The dtype flow is the reference's:
    without a resize the units compute in bf16; behind ``resized`` (its
    prologue casts back to the spec's float32) in float32 with the bf16
    dequantized weights; the fast path casts to its float32 compute dtype
    either way and folds BN from the dequantized weights. The float32
    body's weight-layout cache is not consulted: the weights a route sees
    are each forward's own dequantized bf16 tensors."""
    jmf, tmf, _ = _get(pairs, name)
    src = SIZES[name][resize]
    x = _inputs(name, src, seed=33 + resize)
    jrun, trun = (jmf.resized(src), tmf.resized(src)) if resize else (jmf,
                                                                       tmf)
    ref = jrun.with_dtype("int8").apply_batch(x, batch_size=2)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].dtype))
        for m in trun.with_dtype("int8").variables.modules()
        if isinstance(m, (layers.SeparableConvBN, layers.Dense))]
    layouts = dict(kernels._kn_weights)
    kernels.reset_launches()
    ours = trun.with_dtype("int8").apply_batch(x, batch_size=2,
                                               device="cpu")
    for h in hooks:
        h.remove()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert max_abs(ours, ref) <= BF16_TOLERANCE * np.abs(ref).max()
    assert kernels._kn_weights.keys() == layouts.keys()
    assert not any(kernels.launches.values())  # CPU: plain versions only
    if name == "xception_two_block":
        assert set(seen) == {torch.float32 if resize else torch.bfloat16}


def test_registry_precision_int8_matches_reference(pairs):
    """``build_featurizer(precision="int8")`` in both packages."""
    _, _, vs = _get(pairs, "testnet")
    ref_mf = jax_registry.build_featurizer("TestNet", weights=vs,
                                           precision="int8")
    ours_mf = registry.build_featurizer("TestNet", weights=vs,
                                        precision="int8")
    x = _inputs("testnet", (32, 32), seed=35)
    ref = ref_mf.apply_batch(x, batch_size=2)
    ours = ours_mf.apply_batch(x, batch_size=2, device="cpu")
    assert max_abs(ours, ref) <= BF16_TOLERANCE * np.abs(ref).max()


# -- weight bytes, routing, memoization ---------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_weight_bytes_against_reference(pairs, name):
    """float32: equal. int8: the kernels' payload and scales equal the
    reference's; each other float element counts 2 bytes (bf16) where
    the reference counts 4."""
    jmf, tmf, _ = _get(pairs, name)
    assert tmf.weight_bytes() == jmf.weight_bytes()
    ref, ours = jmf.with_dtype("int8"), tmf.with_dtype("int8")
    rest = sum(leaf.size for _, leaf in _flat(ref.variables)
               if not jax_mfn._is_q8_leaf(leaf))
    assert ours.weight_bytes() == ref.weight_bytes() - 2 * rest
    q8 = sum(t.nbytes for n, t in ours.variables.state_dict().items()
             if "weight_q8" in n)
    assert q8 == sum(leaf[k].nbytes for _, leaf in _flat(ref.variables)
                     if jax_mfn._is_q8_leaf(leaf)
                     for k in (jax_mfn._Q8_WEIGHTS, jax_mfn._Q8_SCALE))
    assert ours.weight_bytes() < 0.5 * tmf.weight_bytes()


def test_int8_keeps_kernel_routable_as_reference(pairs):
    jmf, tmf, _ = _get(pairs, "xception_two_block")
    for jrun, trun in ((jmf, tmf), (jmf.resized((23, 21)),
                                    tmf.resized((23, 21)))):
        assert trun.with_dtype("int8").kernel_routable \
            == jrun.with_dtype("int8").kernel_routable is True
        assert trun.with_dtype("bfloat16").kernel_routable \
            == jrun.with_dtype("bfloat16").kernel_routable is False
    plain = ModelFunction(lambda vs, x: x, None, TensorSpec((None, 3)))
    assert plain.with_dtype("int8").kernel_routable is False
    assert JaxModelFunction(lambda vs, x: x, None, JaxTensorSpec(
        (None, 3))).with_dtype("int8").kernel_routable is False


def test_one_int8_variant_under_eight_threads():
    """Eight partition threads asking at once get one variant, quantized
    once: the coalescing executor keys its queues on it."""
    tmf = ModelFunction.fromModule(TwoBlock(), TensorSpec((None, 19, 19, 3)))
    calls = []
    quantize = mfn._quantized_module

    def counting(module):
        calls.append(threading.current_thread().name)
        return quantize(module)

    barrier = threading.Barrier(8, timeout=10)
    got = [None] * 8

    def ask(i):
        barrier.wait()
        got[i] = tmf.with_dtype("int8")

    mfn._quantized_module = counting
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        mfn._quantized_module = quantize
    assert all(g is got[0] for g in got) and got[0] is not None
    assert len(calls) == 1


# -- the knob -----------------------------------------------------------------


def test_engine_config_int8_threads_through_execute(pairs):
    """``inference_precision="int8"`` validates in both packages and the
    executor runs the memoized variant: equal to its ``apply_batch``, and
    within tolerance of the reference's execute under the same knob."""
    jmf, tmf, _ = _get(pairs, "xception_two_block")
    EngineConfig.inference_precision = "int8"
    EngineConfig.validate()
    x = _inputs("xception_two_block", (19, 19), seed=36)
    ours = executor.execute(tmf, x, batch_size=4)
    assert tmf.with_dtype("int8") in tmf._precision_cache.values()
    assert np.array_equal(
        ours, tmf.with_dtype("int8").apply_batch(x, batch_size=4,
                                                 device="cpu"))
    saved = JaxEngineConfig.snapshot()
    JaxEngineConfig.inference_precision = "int8"
    try:
        ref = jax_executor.execute(jmf, x, batch_size=4)
    finally:
        jax_executor.reset()
        JaxEngineConfig.restore(saved)
    assert max_abs(ours, ref) <= BF16_TOLERANCE * np.abs(ref).max()
    EngineConfig.inference_precision = "float16"
    with pytest.raises(ValueError, match="inference_precision"):
        EngineConfig.validate()
