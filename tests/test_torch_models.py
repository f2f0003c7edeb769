"""The port's model layers and Xception against the JAX package's Flax ones.

Tolerances:
- float32, one layer: max|Δ| ≤ 1e-5·max(1, max|ref|) (sums reassociate);
- float32, whole model: max|Δ| ≤ 1e-3·max|ref| (36 conv layers of
  reassociated sums, plus the folded BN of the sep2d route against the
  reference's unfolded BN);
- bfloat16: max|Δ| ≤ 0.05, the JAX package's ``BF16_TOLERANCE``.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from sparkdl_tpu.core.kernels import BF16_TOLERANCE
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.models.layers import SeparableConvBN as JaxSeparableConvBN
from sparkdl_tpu.models.xception import Xception as JaxXception
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.layers import SeparableConvBN, same_pads
from sparkdl_tpu_torch.models.xception import Xception
from tests.torch_port_helpers import headless, max_abs, random_variables


@pytest.fixture
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    yield
    EngineConfig.restore(saved)


@pytest.fixture
def force_routes(monkeypatch):
    """Every feasible kernel site routes (on the CPU, to the kernel's
    plain version), with no audition and no collection pass."""
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")


def _port_sep(variables, cin, cout, family="xception"):
    m = SeparableConvBN(cin, cout, kernel_family=family)
    m.load_state_dict(from_flax_variables("sep", variables))
    return m.eval()


@pytest.mark.parametrize("routed", [True, False])
def test_separable_conv_bn_matches_flax(routed, force_routes):
    cin, cout = 16, 24
    jm = JaxSeparableConvBN(cout)
    vs = random_variables(jm, (1, 7, 9, cin), seed=3)
    x = np.random.default_rng(4).normal(size=(2, 7, 9, cin)).astype(
        np.float32)
    ref = np.asarray(jm.apply(vs, x))
    tm = _port_sep(vs, cin, cout, "xception" if routed else None)
    with torch.inference_mode():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert max_abs(ours, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("size,pads", [(147, (1, 1)), (74, (0, 1)),
                                       (37, (1, 1)), (19, (1, 1)),
                                       (18, (0, 1))])
def test_same_pool_padding_is_xlas(size, pads):
    """XLA "SAME" splits an odd total pad with the extra cell after."""
    assert same_pads(size, 3, 2) == pads


@pytest.fixture(scope="module")
def xception_pair():
    jm = JaxXception(include_top=True)
    vs = random_variables(jm, (1, 75, 75, 3), seed=0)
    tm = Xception(include_top=True)
    tm.load_state_dict(from_flax_variables("Xception", vs))
    return jm, vs, tm.eval()


def test_xception_full_width_matches_flax(xception_pair, force_routes):
    """All 36 conv layers at full width, 75×75 (there the 18→9 pool pads
    asymmetrically), batch 2, float32: features and softmax."""
    jm, vs, tm = xception_pair
    x = np.random.default_rng(5).normal(size=(2, 75, 75, 3)).astype(
        np.float32)
    ref_probs = np.asarray(jax.jit(jm.apply)(vs, x))
    jh = JaxXception(include_top=False, pooling="avg")
    ref_feats = np.asarray(jax.jit(jh.apply)(headless(vs), x))
    th = Xception(include_top=False)
    th.load_state_dict({k: v for k, v in tm.state_dict().items()
                        if not k.startswith("predictions")})
    kernels.reset_launches()
    with torch.inference_mode():
        probs = tm(torch.from_numpy(x)).numpy()
        feats = th.eval()(torch.from_numpy(x)).numpy()
    assert kernels.launches["sep2d"] == 0  # CPU: plain versions only
    assert feats.shape == (2, 2048) and probs.shape == (2, 1000)
    assert max_abs(feats, ref_feats) <= 1e-3 * np.abs(ref_feats).max()
    assert max_abs(probs, ref_probs) <= 1e-3 * np.abs(ref_probs).max()


def test_bf16_flow_at_one_layer(cpu_engine, force_routes):
    """``with_dtype("bfloat16")`` in both packages: without a resize the
    layer runs in bf16; behind ``resized`` (whose cast brings the input
    back to the spec's float32) it runs in float32 with bf16-rounded
    weights — the reference's flow, reproduced, not fixed."""
    cin, cout = 3, 8
    jm = JaxSeparableConvBN(cout)
    vs = random_variables(jm, (1, 6, 6, cin), seed=6)
    jmf = JaxModelFunction.fromFlax(jm, vs, JaxTensorSpec((None, 6, 6, cin)),
                                    train=False)
    tmod = _port_sep(vs, cin, cout)
    seen = []
    tmod.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    tmf = ModelFunction.fromModule(tmod, TensorSpec((None, 6, 6, cin)))
    rng = np.random.default_rng(7)
    for src in ((6, 6), (4, 5)):
        x = rng.integers(0, 256, size=(2, *src, cin)).astype(np.uint8)
        ref = jmf.resized(src).with_dtype("bfloat16").apply_batch(
            x, batch_size=8)
        seen.clear()
        ours = tmf.resized(src).with_dtype("bfloat16").apply_batch(
            x, batch_size=8, device="cpu")
        assert seen == [torch.bfloat16 if src == (6, 6) else torch.float32]
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        # bf16 relative: the activations here are O(100) (uint8 input)
        assert max_abs(ours, ref) <= BF16_TOLERANCE * max(
            1.0, np.abs(ref).max())


def test_flax_bf16_conv_promotes_to_f32():
    """The reference fact the flow above rests on: a Flax conv with bf16
    weights and float32 input computes and returns float32."""
    conv = fnn.Conv(4, (1, 1), use_bias=False)
    vs = jax.tree_util.tree_map(
        lambda a: a.astype("bfloat16"),
        conv.init(jax.random.PRNGKey(0), np.zeros((1, 2, 2, 3), np.float32)))
    y = conv.apply(vs, np.ones((1, 2, 2, 3), np.float32))
    assert y.dtype == np.float32


def test_weight_sources_agree(tmp_path):
    """``weights=`` as "random" (seeded), a state dict, a state-dict file
    and a Flax numpy tree build the same model."""
    from sparkdl_tpu_torch.models import registry

    seeded = registry.build_featurizer("Xception", weights="random", seed=9)
    again = registry.build_featurizer("Xception", weights="random", seed=9)
    state = seeded.variables.state_dict()
    path = tmp_path / "xception.pt"
    torch.save(state, path)
    from_file = registry.build_featurizer("Xception", weights=str(path))
    flax_tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *mod, leaf = key.split(".")
        arr = value.numpy()
        if leaf == "weight" and arr.ndim == 4:
            coll, leaf, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            coll, leaf = "params", "scale"
        elif leaf == "bias":
            coll = "params"
        else:
            coll, leaf = "batch_stats", {"running_mean": "mean",
                                         "running_var": "var"}[leaf]
        node = flax_tree[coll]
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = arr
    from_tree = registry.build_featurizer("Xception", weights=flax_tree)
    x = np.random.default_rng(10).integers(0, 256, (1, 71, 71, 3), np.uint8)
    outs = [mf.apply_batch(x, batch_size=1, device="cpu")
            for mf in (seeded, again, from_file, from_tree)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert not np.allclose(
        outs[0], registry.build_featurizer("Xception", seed=8).apply_batch(
            x, batch_size=1, device="cpu"))
