"""The registry's ``dtype`` against the JAX package's, on the CPU.

The reference builds its Flax modules with ``dtype``: every op casts its
input and its float32 weights to it, a BN with float32 statistics computes
in float32 and rounds once, and the model stays kernel-routable. The
port's layers take the same compute dtype. Tolerance: bf16 max|Δ| ≤ 0.05
(``BF16_TOLERANCE``), relative to max(1, max|ref|) for a whole model.

The ``large`` layer cases hold |x| ≈ 10 with weights that pass x through
exactly (an identity pointwise, a depthwise with only its centre tap), so
only the BN's promotion is compared: there a BN computed all in bf16
(statistics rounded to bf16) lies 0.0625-0.125 from the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.core.kernels import BF16_TOLERANCE
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models.layers import ConvBN as JaxConvBN
from sparkdl_tpu.models.layers import SeparableConvBN as JaxSeparableConvBN
from sparkdl_tpu.models.xception import Xception as JaxXception
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.layers import ConvBN, SeparableConvBN
from tests.torch_port_helpers import max_abs, random_variables

C = 8          # channels of the layer cases
SIZE = 71      # Xception's smallest input


@pytest.fixture
def force_routes(monkeypatch):
    """Every feasible kernel site routes (on the CPU, to the kernel's
    plain version), with no audition and no collection pass."""
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")


def _layer_pair(kind, case, routed):
    """(Flax module, its variables, the port's module, input) for one
    layer case; both modules compute in bf16."""
    rng = np.random.default_rng(11)
    if kind == "convbn":
        jm = JaxConvBN(C, (1, 1), dtype=jnp.bfloat16)
        tm = ConvBN(C, C, (1, 1), kernel_family="unit" if routed else None,
                    dtype=torch.bfloat16)
    else:
        jm = JaxSeparableConvBN(C, dtype=jnp.bfloat16)
        tm = SeparableConvBN(C, C, kernel_family="unit" if routed else None,
                             dtype=torch.bfloat16)
    vs = random_variables(jm, (1, 5, 6, C), seed=12)
    x = rng.normal(size=(2, 5, 6, C))
    if case == "large":
        mean = 10.0 + rng.normal(size=C) * 0.3
        x = mean + rng.normal(size=(2, 5, 6, C)) * 0.3
        bn = vs["batch_stats"]["bn"]
        bn["mean"] = mean.astype(np.float32)
        if kind == "convbn":  # no γ: the statistics scale by ~4
            vs["params"]["conv"]["kernel"] = np.eye(C, dtype=np.float32)[
                None, None]
            bn["var"] = (0.0625 + np.abs(rng.normal(size=C)) * 0.01).astype(
                np.float32)
        else:
            dw = np.zeros((3, 3, 1, C), np.float32)
            dw[1, 1] = 1.0
            vs["params"]["depthwise"]["kernel"] = dw
            vs["params"]["pointwise"]["kernel"] = np.eye(
                C, dtype=np.float32)[None, None]
            vs["params"]["bn"]["scale"] = (
                4.0 + rng.normal(size=C) * 0.1).astype(np.float32)
    tm.load_state_dict(from_flax_variables(kind, vs))
    return jm, vs, tm.eval(), x.astype(np.float32)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("case", ["random", "large"])
@pytest.mark.parametrize("kind", ["convbn", "sepconv"])
def test_bf16_layer_matches_flax_dtype(kind, case, routed, force_routes):
    """The port's layer with ``dtype=bf16`` against the Flax layer with
    ``dtype=jnp.bfloat16``, from the same numpy variables: the plain body,
    and the kernel route (its plain version, on operands of the dtype)."""
    jm, vs, tm, x = _layer_pair(kind, case, routed)
    ref = np.asarray(jm.apply(vs, x).astype(jnp.float32))
    kernels.reset_launches()
    with torch.inference_mode():
        y = tm(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    assert not any(kernels.launches.values())  # CPU: plain versions only
    assert max_abs(y.float().numpy(), ref) <= BF16_TOLERANCE
    # the module's parameters and statistics stay float32
    assert {t.dtype for t in tm.state_dict().values()} == {torch.float32}
    if case == "large" and not routed:
        # what the case guards: BN in bf16 throughout (statistics rounded
        # to bf16), as the port computed before its layers took a dtype
        old = type(tm)(C, C, *(((1, 1),) if kind == "convbn" else ()))
        old.load_state_dict(tm.state_dict())
        with torch.inference_mode():
            y_old = old.eval().to(torch.bfloat16)(
                torch.from_numpy(x).to(torch.bfloat16))
        assert max_abs(y_old.float().numpy(), ref) > BF16_TOLERANCE


@pytest.fixture(scope="module")
def xception_variables():
    return random_variables(JaxXception(include_top=False, pooling="avg"),
                            (1, SIZE, SIZE, 3), seed=13)


def test_bf16_featurizer_is_kernel_routable_in_both(xception_variables):
    """``build_featurizer(dtype="bfloat16")`` builds the module with the
    dtype in both packages: kernel-routable, float32 weights and
    statistics in the port."""
    kw = dict(weights=xception_variables, dtype="bfloat16", fast=False)
    ref = jax_registry.build_featurizer("Xception", **kw)
    ours = registry.build_featurizer("Xception", **kw)
    assert ref.kernel_routable and ours.kernel_routable
    assert {t.dtype for t in ours.variables.state_dict().values()} \
        == {torch.float32}
    for name in ("InceptionV3", "Xception"):
        assert registry.build_predictor(name, dtype="bfloat16",
                                        fast=False).kernel_routable


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_unpreprocessed_featurizer_matches_reference(xception_variables,
                                                     dtype):
    """``preprocess=False`` in both packages, float32 and bf16: the input
    goes to the network as given (here already in [-1, 1])."""
    x = np.random.default_rng(14).uniform(
        -1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(weights=xception_variables, dtype=dtype, fast=False,
              preprocess=False)
    ref = jax_registry.build_featurizer("Xception", **kw).apply_batch(
        x, batch_size=1)
    ours = registry.build_featurizer("Xception", **kw).apply_batch(
        x, batch_size=1, device="cpu")
    tol = (BF16_TOLERANCE if dtype else 1e-3) * max(1.0, np.abs(ref).max())
    assert ours.shape == ref.shape == (1, 2048)
    assert max_abs(ours, ref) <= tol
    # preprocess=True on the raw [0, 255] values is the same model
    raw = ((x + 1.0) * 127.5).astype(np.float32)
    scaled = registry.build_featurizer(
        "Xception", weights=xception_variables, dtype=dtype,
        fast=False).apply_batch(raw, batch_size=1, device="cpu")
    assert max_abs(scaled, ours) <= tol


@pytest.mark.parametrize("name,fast", [("Xception", False),
                                       ("InceptionV3", True)])
def test_precision_keyword_applies_with_dtype(name, fast):
    """``precision="bfloat16"`` is ``with_dtype("bfloat16")`` on the
    finished model, as the reference's ``_apply_precision``: not
    kernel-routable, ``fast_path`` kept; None and "float32" change
    nothing."""
    plain = registry.build_featurizer(name, seed=5, fast=fast)
    bf16 = registry.build_featurizer(name, seed=5, fast=fast,
                                     precision="bfloat16")
    assert bf16.fast_path is plain.fast_path is fast
    assert plain.kernel_routable is (not fast)
    assert not bf16.kernel_routable
    for same in (None, "float32"):
        mf = registry.build_predictor(name, seed=5, fast=fast,
                                      precision=same)
        assert mf.kernel_routable is (not fast)
    x = np.random.default_rng(15).integers(0, 256, (1, 75, 75, 3),
                                           np.uint8)
    np.testing.assert_array_equal(
        bf16.apply_batch(x, batch_size=1, device="cpu"),
        plain.with_dtype("bfloat16").apply_batch(x, batch_size=1,
                                                 device="cpu"))
    with pytest.raises(ValueError):
        registry.build_featurizer(name, precision="int4")
