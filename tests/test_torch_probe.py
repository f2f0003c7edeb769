"""The port's depthwise probes against the TPU script's Pallas probes.

``sparkdl_tpu_torch.experiments.probe``'s plain versions (what each probe
wrapper runs for a CPU tensor) are held against
``experiments/pallas_probe.py``'s ``fma9``, ``dw2d`` and ``sep2d`` in
interpret mode (one grid step over the two images), on the same numpy
inputs: two images at the full width C = 728, all 736 rows, the dead pad
rows included. The live rows are also held against the TPU script's XLA
references, and the port's library yardsticks against the same.

Tolerance: bf16 max|Δ| ≤ 0.05·max(1, max|ref|). The two sides round
differently: the port sums each tap in float32 and rounds once, the
Pallas probes round each product and partial sum to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import experiments.pallas_probe as jp
from sparkdl_tpu_torch.experiments import probe as tp

BF16_REL = 0.05


@pytest.fixture(scope="module")
def inputs():
    """Two images and the probe's weights, drawn as the TPU script's
    ``main()`` draws them, as float32 numpy rounded to bf16."""
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    return {
        "x": bf(rng.normal(size=(2, tp.H, tp.W, tp.C))),
        "k9": bf(rng.normal(size=(9, tp.C)) * 0.2),
        "pw": bf(rng.normal(size=(tp.C, tp.C)) * 0.03),
        "sc": bf(np.abs(rng.normal(size=(1, tp.C)))),
        "sh": bf(rng.normal(size=(1, tp.C)) * 0.01),
    }


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _check(ours: torch.Tensor, ref) -> None:
    ours = ours.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert ours.shape == ref.shape
    bound = BF16_REL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max())
    assert err <= bound, (err, bound)


def test_pad_rows_matches_the_tpu_layout(inputs):
    x2 = tp.pad_rows(torch.from_numpy(inputs["x"]))
    np.testing.assert_array_equal(x2.numpy(), jp.pad_rows(inputs["x"]))
    np.testing.assert_array_equal(tp.unpad_rows(x2, 2).numpy(), inputs["x"])


@pytest.mark.parametrize("name", ["fma9", "dw2d", "sep2d_probe"])
def test_plain_probe_matches_pallas_on_all_rows(inputs, name, monkeypatch):
    monkeypatch.setattr(jp, "GRID", 1)
    x2 = jp.pad_rows(inputs["x"])
    args = [inputs["k9"]]
    if name == "sep2d_probe":
        args += [inputs["pw"], inputs["sc"], inputs["sh"]]
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(jp, "sep2d" if name == "sep2d_probe" else name)(
            _jax(x2), *(_jax(a) for a in args))
    ours = getattr(tp, f"plain_{name}")(_torch(x2),
                                        *(_torch(a) for a in args))
    assert ours.dtype == torch.bfloat16
    _check(ours, ref)
    if name != "fma9":  # the dead rows are computed, and not all zero
        dead = ours.float().reshape(2, tp.P_PAD, tp.C)[:, tp.P:]
        assert float(dead.abs().max()) > 0.0


@pytest.mark.parametrize("name", ["dw2d", "sep2d_probe"])
def test_live_rows_match_xla(inputs, name):
    """The live rows of the plain probe and the port's library yardstick
    against the TPU script's XLA reference."""
    x, k9 = inputs["x"], inputs["k9"]
    xt, kt = _torch(x), _torch(k9)
    w_dw, w_pw = tp.library_weights(kt, _torch(inputs["pw"]))
    k4 = _jax(k9.reshape(3, 3, 1, tp.C))
    if name == "dw2d":
        ref = jp.xla_dw(_jax(x), k4)
        plain = tp.plain_dw2d(tp.pad_rows(xt), kt)
        library = tp.library_dw(xt, w_dw)
    else:
        rest = [_torch(inputs[k]) for k in ("pw", "sc", "sh")]
        ref = jp.xla_sep(_jax(x), k4, _jax(inputs["pw"].reshape(
            1, 1, tp.C, tp.C)), _jax(inputs["sc"]), _jax(inputs["sh"]))
        plain = tp.plain_sep2d_probe(tp.pad_rows(xt), kt, *rest)
        library = tp.library_sep(xt, w_dw, w_pw, *rest[1:])
    _check(tp.unpad_rows(plain, 2), ref)
    _check(library, ref)


def test_library_fma9_matches_plain(inputs):
    """The one-call yardstick of fma9 (an einsum, which may sum the taps
    first) against the plain version, all rows."""
    x2 = tp.pad_rows(_torch(inputs["x"]))
    k9 = _torch(inputs["k9"])
    _check(tp.library_fma9(x2, k9), tp.plain_fma9(x2, k9).float().numpy())


def _bump(t: torch.Tensor, index: int, ulps: int) -> torch.Tensor:
    """A copy of bf16 ``t`` with element ``index`` (flat) moved ``ulps``
    representable steps away from zero."""
    out = t.clone()
    out.view(torch.int16).reshape(-1)[index] += ulps
    return out


def test_matches_plain_holds_each_probe_to_its_contract(inputs):
    """fma9 and dw2d must equal their plain versions bit for bit;
    sep2d_probe may sit one bf16 ulp away, not three."""
    x2 = tp.pad_rows(_torch(inputs["x"][:1]))
    k9 = _torch(inputs["k9"])
    rest = [_torch(inputs[k]) for k in ("pw", "sc", "sh")]
    for name in ("fma9", "dw2d"):
        ref = getattr(tp, f"plain_{name}")(x2, k9)
        assert tp.matches_plain(name, ref.clone(), ref)
        assert not tp.matches_plain(name, _bump(ref, 5 * tp.C + 7, 1), ref)
        assert not tp.matches_plain(name, ref.float(), ref)
    ref = tp.plain_sep2d_probe(x2, k9, *rest)
    big = int(ref.float().abs().argmax())
    assert tp.matches_plain("sep2d_probe", _bump(ref, big, 1), ref)
    assert not tp.matches_plain("sep2d_probe", _bump(ref, big, 3), ref)


def test_wrappers_take_the_plain_version_on_the_cpu(inputs):
    tp.reset_launches()
    x2 = tp.pad_rows(_torch(inputs["x"][:1]))
    k9 = _torch(inputs["k9"])
    assert torch.equal(tp.fma9(x2, k9), tp.plain_fma9(x2, k9))
    assert torch.equal(tp.dw2d(x2, k9), tp.plain_dw2d(x2, k9))
    rest = [_torch(inputs[k]) for k in ("pw", "sc", "sh")]
    assert torch.equal(tp.sep2d_probe(x2, k9, *rest),
                       tp.plain_sep2d_probe(x2, k9, *rest))
    assert tp.launches == {"fma9": 0, "dw2d": 0, "sep2d_probe": 0}
    with pytest.raises(ValueError, match="not supported"):
        tp.dw2d(x2.to("meta"), k9.to("meta"))


def test_main_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        tp.main("cpu")
