"""Train-mode BatchNorm of the port against ``flax.linen.BatchNorm``.

``sparkdl_tpu_torch.models.layers.BatchNorm`` under ``module.train()``
against ``flax.linen.BatchNorm(use_running_average=False)`` on the same
numpy inputs: the output, the running statistics after several steps
(each model's momentum: 0.99, MobileNetV2's 0.999) and the gradients;
then the reference's ``ConvBN`` and ``SeparableConvBN`` in train mode
against the port's, the bf16 flow (bf16 input and γ/β over float32
statistics, the Trainer's mixed precision) included.

Tolerances:
- float32: max|Δ| ≤ 2e-5·max(1, max|ref|) for outputs and gradients, and
  ≤ 1e-6·max(1, max|ref|) for the running statistics: the batch sums run
  in another order in the two frameworks;
- bfloat16 outputs: max|Δ| ≤ 2⁻⁷·max(1, max|ref|) (two bf16 ulps): both
  round the same float32 normalization once, but the float32 statistics
  differ in their last bits, which can tip a rounding; the statistics
  stay float32 and are held as in float32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import layers as jl
from sparkdl_tpu_torch.models import layers as tl
from sparkdl_tpu_torch.models.convert import from_flax_variables

F32_RTOL = 2e-5
STAT_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7


def _bound(ref, rtol):
    return rtol * max(1.0, float(np.max(np.abs(np.asarray(ref,
                                                          np.float32)))))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= _bound(ref, rtol), (what, err, _bound(ref, rtol))


def _batches(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * (1.0 + i) + 0.5 * i).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("momentum", [0.99, 0.999])
@pytest.mark.parametrize("scale", [True, False])
def test_batchnorm_train_matches_flax_over_steps(momentum, scale):
    c, eps = 6, 1e-3
    ref = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                        epsilon=eps, use_scale=scale)
    xs = _batches(4, (3, 5, 4, c), seed=1)
    rng = np.random.default_rng(2)
    variables = ref.init(jax.random.PRNGKey(0), xs[0])
    params = {"bias": rng.normal(size=c).astype(np.float32)}
    if scale:
        params["scale"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    stats = {"mean": (0.1 * rng.normal(size=c)).astype(np.float32),
             "var": (1 + np.abs(rng.normal(size=c))).astype(np.float32)}
    port = tl.BatchNorm(c, eps, scale=scale, momentum=momentum)
    assert not port.training  # a fresh layer is in eval mode, as Flax's
    port.load_state_dict(from_flax_variables(
        "bn", {"params": params, "batch_stats": stats}))
    port.train()
    for step, x in enumerate(xs):
        y_ref, upd = ref.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), mutable=["batch_stats"])
        stats = jax.device_get(upd["batch_stats"])
        y = port(torch.from_numpy(x))
        _close(y, y_ref, F32_RTOL, f"y step {step}")
        _close(port.running_mean, stats["mean"], STAT_RTOL, "mean")
        _close(port.running_var, stats["var"], STAT_RTOL, "var")
    # eval mode uses the running statistics, as use_running_average=True
    port.eval()
    ref_eval = fnn.BatchNorm(use_running_average=True, epsilon=eps,
                             use_scale=scale)
    y_ref = ref_eval.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(xs[0]))
    _close(port(torch.from_numpy(xs[0])), y_ref, F32_RTOL, "eval")


def test_batch_stats_are_the_fast_biased_variance_clipped_at_zero():
    x = torch.tensor([[[[3.0], [3.0]], [[3.0], [3.0]]]])  # constant: var 0
    mean, var = tl.batch_stats(x)
    assert float(mean) == 3.0 and float(var) == 0.0
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 3, 5)).astype(np.float32) * 3 + 40
    mean, var = tl.batch_stats(torch.from_numpy(x))
    xf = jnp.asarray(x)
    mean2 = (xf * xf).mean((0, 1, 2))
    ref_var = jnp.maximum(0.0, mean2 - jnp.square(xf.mean((0, 1, 2))))
    # E[x²] − E[x]² cancels: both packages round E[x²] to float32 (in
    # another summation order), so they agree within a few of its ulps;
    # a two-pass or unbiased variance would be off by far more
    err = float(np.max(np.abs(_np(var) - _np(ref_var))))
    assert err <= 4 * np.finfo(np.float32).eps * float(np.max(mean2))
    unbiased = x.reshape(-1, 5).var(axis=0, ddof=1)
    assert float(np.max(np.abs(_np(var) - unbiased))) > 10 * err


def test_running_variance_is_biased_not_torch_unbiased():
    """F.batch_norm(training=True) would move the running variance by the
    unbiased variance (n/(n−1) larger) with momentum 1 − m: the port
    moves it by the biased one with m, as Flax does."""
    x = torch.from_numpy(_batches(1, (2, 2, 2, 3), seed=3)[0])
    bn = tl.BatchNorm(3, momentum=0.9).train()
    bn(x)
    biased = x.reshape(-1, 3).var(dim=0, unbiased=False)
    want = 0.9 * torch.ones(3) + 0.1 * biased
    assert torch.allclose(bn.running_var, want, rtol=1e-6, atol=1e-7)
    unbiased = 0.9 * torch.ones(3) + 0.1 * x.reshape(-1, 3).var(dim=0)
    assert not torch.allclose(bn.running_var, unbiased, rtol=1e-4)


class _RefUnits(fnn.Module):
    sep: bool
    dtype: object = None

    @fnn.compact
    def __call__(self, x, train: bool = False):
        if self.sep:
            return jl.SeparableConvBN(12, dtype=self.dtype,
                                      name="unit")(x, train)
        return jl.ConvBN(10, (3, 3), strides=(2, 2), dtype=self.dtype,
                         name="unit")(x, train)


class _PortUnits(torch.nn.Module):
    def __init__(self, sep: bool, dtype=None):
        super().__init__()
        self.unit = (tl.SeparableConvBN(6, 12, kernel_family="unit",
                                        dtype=dtype) if sep
                     else tl.ConvBN(6, 10, 3, strides=2, dtype=dtype))

    def forward(self, x):
        return self.unit(x)


def _variables(sep: bool, x):
    variables = _RefUnits(sep).init(jax.random.PRNGKey(1), x[:1])
    variables = jax.device_get(variables)
    rng = np.random.default_rng(5)
    stats = jax.tree.map(
        lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _units(sep, x, dtype=None):
    variables = _variables(sep, x)
    port = _PortUnits(sep, dtype)
    port.load_state_dict(from_flax_variables("units", variables))
    return variables, port.train()


@pytest.mark.parametrize("sep", [False, True])
def test_units_train_mode_outputs_stats_and_grads_match(sep):
    xs = _batches(3, (2, 9, 8, 6), seed=7)
    variables, port = _units(sep, xs[0])
    ref = _RefUnits(sep)
    params, stats = variables["params"], variables["batch_stats"]
    r = np.random.default_rng(9)

    def loss(p, xx, st, w):
        y, upd = ref.apply({"params": p, "batch_stats": st}, xx,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    grad = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    for step, x in enumerate(xs):
        shape = jax.eval_shape(lambda xx: ref.apply(
            {"params": params, "batch_stats": stats}, xx), x).shape
        w = r.normal(size=shape).astype(np.float32)
        (g_params, g_x), (y_ref, stats) = grad(params, jnp.asarray(x),
                                               stats, jnp.asarray(w))
        stats = jax.device_get(stats)
        xt = torch.from_numpy(x).requires_grad_(True)
        port.zero_grad()
        y = port(xt)
        (y * torch.from_numpy(w)).sum().backward()
        _close(y, y_ref, F32_RTOL, f"y step {step}")
        _close(xt.grad, g_x, F32_RTOL, "dx")
        g_ref = from_flax_variables("units", {"params": jax.device_get(
            g_params)})
        for name, p in port.named_parameters():
            _close(p.grad, g_ref[name], F32_RTOL, f"d{name}")
        ref_state = from_flax_variables("units", {"params": params,
                                                  "batch_stats": stats})
        for name, b in port.named_buffers():
            _close(b, ref_state[name], STAT_RTOL, name)


@pytest.mark.parametrize("sep", [False, True])
def test_units_bf16_flow_matches(sep):
    """The Trainer's mixed precision: γ/β and conv kernels cast to bf16,
    the input bf16, the statistics float32 — the output bf16, the
    statistics float32 and moving."""
    xs = _batches(2, (2, 9, 8, 6), seed=11)
    variables, port = _units(sep, xs[0])
    ref = _RefUnits(sep)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                          variables["params"])
    stats = variables["batch_stats"]
    with torch.no_grad():
        for p in port.parameters():
            p.data = p.data.to(torch.bfloat16)
    for step, x in enumerate(xs):
        xb = jnp.asarray(x, jnp.bfloat16)
        y_ref, upd = ref.apply({"params": params, "batch_stats": stats},
                               xb, train=True, mutable=["batch_stats"])
        stats = jax.device_get(upd["batch_stats"])
        y = port(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                 .to(torch.bfloat16))
        assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
        _close(y, y_ref, BF16_RTOL, f"y step {step}")
        ref_state = from_flax_variables("units", {
            "params": variables["params"], "batch_stats": stats})
        for name, b in port.named_buffers():
            assert b.dtype == torch.float32
            _close(b, ref_state[name], 1e-5, name)


def test_fused_units_take_the_plain_body_in_training(monkeypatch):
    """``_fused`` returns None in train mode, so a ``"force"`` gate never
    routes a training forward (and the repair never fires there)."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    x = torch.randn(1, 5, 5, 6, requires_grad=True)
    for unit in (tl.SeparableConvBN(6, 8, kernel_family="f"),
                 tl.ConvBN(6, 8, 1, kernel_family="f")):
        unit.train()
        assert unit._fused(x) is None
        unit(x).sum().backward()
        unit.eval()
        with pytest.raises(ValueError, match="no backward"):
            unit(x)


def test_mobilenet_layers_move_at_0999_and_the_rest_at_099():
    from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
    from sparkdl_tpu_torch.models.xception import Xception

    mbn = [m.momentum for m in MobileNetV2().modules()
           if isinstance(m, tl.BatchNorm)]
    xbn = [m.momentum for m in Xception().modules()
           if isinstance(m, tl.BatchNorm)]
    assert mbn and set(mbn) == {0.999}
    assert xbn and set(xbn) == {0.99}
