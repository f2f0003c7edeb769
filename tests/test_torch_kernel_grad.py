"""A kernel route refuses to run while autograd records through it.

The JAX package's Pallas kernels have no backward (no ``custom_vjp``):
``jax.grad`` through ``sparkdl_tpu.core.kernels.sep2d``, ``pw1x1`` or
``preproc_resize`` (interpret mode on the CPU) raises ``ValueError``.
The port's routes under ``"force"`` raise ``ValueError`` too wherever an
operand requires grad and grad mode is on, on the CPU as on the card,
instead of handing back the plain version's differentiable output (on
the CPU) or an output cut off from the graph (on the card). Under
``torch.no_grad()`` (and ``inference_mode``) they still answer, and
equal the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.core import kernels as jk
from sparkdl_tpu_torch.core import kernels as tk

EPS = 1e-3
B, H, W, CIN, COUT = 1, 4, 5, 8, 8


@pytest.fixture
def force(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    tk.reset_launches()
    yield
    assert tk.launches == {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}


def _operands():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, CIN)).astype(np.float32)
    dw = (rng.normal(size=(3, 3, 1, CIN)) * 0.2).astype(np.float32)
    pw = (rng.normal(size=(1, 1, CIN, COUT)) * 0.3).astype(np.float32)
    gamma = (np.abs(rng.normal(size=COUT)) + 0.5).astype(np.float32)
    beta = (rng.normal(size=COUT) * 0.1).astype(np.float32)
    mean = (rng.normal(size=COUT) * 0.1).astype(np.float32)
    var = (np.abs(rng.normal(size=COUT)) + 1.0).astype(np.float32)
    img = rng.integers(0, 256, (B, 6, 7, 3)).astype(np.float32)
    return dict(x=x, dw=dw, pw=pw, gamma=gamma, beta=beta, mean=mean,
                var=var, img=img)


def _reference_grad(kernel: str, wrt: str, ops):
    """``jax.grad`` of the reference's Pallas kernel (interpret mode)
    with respect to one operand."""
    dw9 = jnp.asarray(ops["dw"].reshape(9, CIN))
    pw2 = jnp.asarray(ops["pw"].reshape(CIN, COUT))
    scale = jnp.asarray(ops["gamma"] / np.sqrt(ops["var"] + EPS))[None]
    shift = (jnp.asarray(ops["beta"]) - jnp.asarray(ops["mean"])
             * scale[0])[None]
    x = jnp.asarray(ops["x"])
    if kernel == "sep2d":
        args = {"x": x, "weight": pw2}

        def f(a):
            kw = dict(args, **{wrt: a})
            return jk.sep2d(kw["x"], dw9, kw["weight"], scale, shift,
                            interpret=True).sum()
    elif kernel == "pw1x1":
        args = {"x": x, "weight": pw2}

        def f(a):
            kw = dict(args, **{wrt: a})
            return jk.pw1x1(kw["x"], kw["weight"], scale, shift,
                            relu=True, interpret=True).sum()
    else:
        args = {"x": jnp.asarray(ops["img"])}

        def f(a):
            return jk.preproc_resize(a, (9, 4), jnp.float32,
                                     interpret=True).sum()
    return jax.grad(f)(args[wrt])


def _port_route(kernel: str, wrt: str, ops):
    """The port's route of ``kernel`` with ``wrt`` requiring grad; the
    plain version's answer beside it."""
    t = {k: torch.from_numpy(v.copy()) for k, v in ops.items()}
    dw = t["dw"].permute(3, 2, 0, 1).contiguous()          # (C, 1, 3, 3)
    pw = t["pw"].permute(3, 2, 0, 1).contiguous()          # (O, I, 1, 1)
    x = t["img"] if kernel == "preproc" else t["x"]
    if wrt == "x":
        x.requires_grad_(True)
    else:
        pw.requires_grad_(True)
    if kernel == "sep2d":
        def route():
            return tk.route_sep2d(x, dw, pw, t["gamma"], t["beta"],
                                  t["mean"], t["var"], EPS, family="unit")
        scale, shift = tk._fold_bn(t["gamma"], t["beta"], t["mean"],
                                   t["var"], EPS)
        plain = tk.plain_sep2d(x.detach(), t["dw"].reshape(9, CIN),
                               t["pw"].reshape(CIN, COUT), scale, shift)
    elif kernel == "pw1x1":
        def route():
            return tk.route_pw1x1(x, pw, t["gamma"], t["beta"], t["mean"],
                                  t["var"], EPS, relu=True, family="unit")
        scale, shift = tk._fold_bn(t["gamma"], t["beta"], t["mean"],
                                   t["var"], EPS)
        plain = tk.plain_pw1x1(x.detach(), t["pw"].reshape(CIN, COUT),
                               scale, shift, relu=True)
    else:
        def route():
            return tk.route_preproc(x, (9, 4), torch.float32,
                                    family="unit")
        plain = tk.plain_preproc(x.detach(), (9, 4), torch.float32)
    return route, plain


CASES = [("sep2d", "x"), ("sep2d", "weight"), ("pw1x1", "x"),
         ("pw1x1", "weight"), ("preproc", "x")]


@pytest.mark.parametrize("kernel,wrt", CASES)
def test_grad_through_a_kernel_raises_in_both_packages(force, kernel, wrt):
    ops = _operands()
    with pytest.raises(ValueError, match="Linearization failed"):
        _reference_grad(kernel, wrt, ops)
    route, _ = _port_route(kernel, wrt, ops)
    with pytest.raises(ValueError, match="no backward"):
        route()


@pytest.mark.parametrize("kernel,wrt", CASES)
@pytest.mark.parametrize("scope", ["no_grad", "inference_mode"])
def test_route_answers_when_nothing_records(force, kernel, wrt, scope):
    route, plain = _port_route(kernel, wrt, _operands())
    ctx = torch.no_grad() if scope == "no_grad" else torch.inference_mode()
    with ctx:
        out = route()
    assert out is not None and not out.requires_grad
    assert torch.equal(out, plain)


def test_autotune_and_off_route_nothing_so_training_is_unaffected(
        monkeypatch):
    """The default gate routes no site without an adopted verdict (none
    on the CPU), and ``"off"`` routes none: grad flows through the plain
    layers of a fused unit."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig
    from sparkdl_tpu_torch.models.layers import SeparableConvBN

    unit = SeparableConvBN(CIN, COUT, kernel_family="unit").eval()
    gen = torch.Generator().manual_seed(0)
    for conv in (unit.depthwise, unit.pointwise):
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
    x = torch.from_numpy(_operands()["x"]).requires_grad_(True)
    for mode in ("autotune", "off"):
        monkeypatch.setattr(EngineConfig, "pallas_kernels", mode)
        unit.zero_grad()
        unit(x).sum().backward()
        assert unit.pointwise.weight.grad is not None
        assert float(unit.pointwise.weight.grad.abs().sum()) > 0
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    with pytest.raises(ValueError, match="sep2d"):
        unit(x)
