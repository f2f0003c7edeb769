"""The whole training slice against the JAX package's.

Both trainers start from the same numpy variables (the reference's Flax
init, carried into the port's module by ``models/convert.py``) and fit
the same seeded batches: ``Trainer.from_flax`` against
``Trainer.from_module`` on TestNet (the registry's 32×32 CNN, no
BatchNorm) and on a small stack of the reference's ``ConvBN`` and
``SeparableConvBN`` against the port's counterparts (train-mode
BatchNorm: batch statistics, running statistics updated in the step).
Per-step losses, the trained params and the running statistics are held.

Tolerances:
- losses at every step: rtol 1e-5;
- SGD params and statistics: max|Δ| ≤ 1e-5·max(1, max|ref|) per leaf;
- Adam params: the first Adam updates are close to ±lr·sign(g), so an
  element whose gradient is near 0 in both packages can flip its sign
  between them: every element is held within 2·lr·steps (the most two
  opposite runs of such updates can part), and at most 2% of a leaf's
  elements may differ by more than 1e-5·max(1, max|ref|);
- bf16 compute (``compute_dtype``): the losses of 4 SGD steps rtol 2e-2
  and the params after them within 2e-2·max(1, max|ref|): the forward
  and backward round to bf16 in each op, in another op order in each
  framework.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import layers as jl
from sparkdl_tpu.models.testnet import TestNet as JTestNet
from sparkdl_tpu.train import MetricsLogger as JLogger
from sparkdl_tpu.train import Trainer as JTrainer
from sparkdl_tpu_torch.models import layers as tl
from sparkdl_tpu_torch.models.convert import from_flax_variables
from sparkdl_tpu_torch.models.testnet import TestNet as PortTestNet
from sparkdl_tpu_torch.train import MetricsLogger, Trainer

LOSS_RTOL = 1e-5
SGD_RTOL = 1e-5
ADAM_FAR = 0.02
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "device", "cpu")


class RefStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jl.ConvBN(8, (3, 3), strides=(2, 2), name="unit1")(x, train)
        x = jl.SeparableConvBN(12, name="unit2")(x, train)
        x = jnp.mean(x, axis=(1, 2))
        return jax.nn.softmax(fnn.Dense(4, name="predictions")(x), axis=-1)


class PortStack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.unit1 = tl.ConvBN(3, 8, 3, strides=2)
        self.unit2 = tl.SeparableConvBN(8, 12, kernel_family="stack")
        self.predictions = tl.Dense(12, 4)

    def forward(self, x):
        x = self.unit2(self.unit1(x)).mean(dim=(1, 2))
        return torch.softmax(self.predictions(x), dim=-1)


def _data(size, classes, n=32, batch=8, seed=0):
    """uint8 images whose mean brightness follows the class, one-hot
    labels: ``n // batch`` batches."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, classes, size=n)
    x = rng.integers(0, 128, size=(n, size, size, 3)).astype(np.int32)
    x = np.clip(x + (ids * 100 // classes)[:, None, None, None], 0, 255)
    y = np.eye(classes, dtype=np.float32)[ids]
    return [(x[i:i + batch].astype(np.uint8), y[i:i + batch])
            for i in range(0, n, batch)]


def _models(kind):
    if kind == "testnet":
        ref, port, size, classes = JTestNet(), PortTestNet(), 32, 10
    else:
        ref, port, size, classes = RefStack(), PortStack(), 12, 4
    variables = jax.device_get(ref.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, size, size, 3))))
    if "batch_stats" in variables:
        rng = np.random.default_rng(3)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5)
            .astype(np.float32), variables["batch_stats"])
    port.load_state_dict(from_flax_variables(kind, variables))
    return ref, port, variables, _data(size, classes)


def _fit_both(kind, optimizer, lr, epochs=2, **kwargs):
    ref, port, variables, batches = _models(kind)
    jt, js = JTrainer.from_flax(ref, variables, optimizer=optimizer,
                                learning_rate=lr, **kwargs)
    jlog = JLogger(sinks=[lambda r: None])
    js = jt.fit(js, batches, epochs=epochs, metrics_logger=jlog)
    tt, ts = Trainer.from_module(port, optimizer=optimizer,
                                 learning_rate=lr, **kwargs)
    assert ts.step.device.type == "cpu"
    tlog = MetricsLogger(sinks=[lambda r: None])
    ts = tt.fit(ts, batches, epochs=epochs, metrics_logger=tlog)
    ref_vars = jax.device_get({"params": js.params, **js.model_state})
    return jlog.history, tlog.history, from_flax_variables(kind, ref_vars), \
        ts, tt


def _np(t):
    return t.detach().float().numpy()


def _hold_losses(jhist, thist, rtol):
    assert [r["step"] for r in thist] == [r["step"] for r in jhist]
    np.testing.assert_allclose([r["loss"] for r in thist],
                               [r["loss"] for r in jhist], rtol=rtol)
    for a, b in zip(thist, jhist):
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)


def _hold_sgd(ref_state, ts, rtol):
    for name, ref in ref_state.items():
        got = ts.params.get(name, ts.model_state.get(name))
        r = ref.numpy()
        bound = rtol * max(1.0, float(np.max(np.abs(r))))
        assert float(np.max(np.abs(_np(got) - r))) <= bound, name


@pytest.mark.parametrize("kind", ["testnet", "stack"])
def test_sgd_fit_matches_reference(kind):
    jhist, thist, ref_state, ts, _ = _fit_both(kind, "sgd", 0.1)
    assert len(thist) == 8 and int(ts.step) == 8
    _hold_losses(jhist, thist, LOSS_RTOL)
    _hold_sgd(ref_state, ts, SGD_RTOL)
    if kind == "stack":
        # the running statistics moved, and are held with the params
        assert set(ts.model_state) == {
            n for n in ref_state if n.endswith(("running_mean",
                                                "running_var"))}


@pytest.mark.parametrize("kind", ["testnet", "stack"])
def test_adam_fit_matches_reference(kind):
    lr, steps = 1e-3, 8
    jhist, thist, ref_state, ts, _ = _fit_both(kind, "adam", lr)
    _hold_losses(jhist, thist, LOSS_RTOL)
    for name, ref in ref_state.items():
        got, r = _np(ts.params.get(name, ts.model_state.get(name))), \
            ref.numpy()
        diff = np.abs(got - r)
        # the sign-flip bound, held explicitly on every element
        assert float(np.max(diff)) <= 2 * lr * steps, name
        far = diff > SGD_RTOL * max(1.0, float(np.max(np.abs(r))))
        assert far.mean() <= ADAM_FAR, (name, far.mean())


def test_bf16_compute_fit_tracks_reference():
    jhist, thist, ref_state, ts, tt = _fit_both(
        "testnet", "sgd", 0.1, epochs=1, compute_dtype="bfloat16")
    assert tt.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in ts.params.values())
    assert len(thist) == 4
    np.testing.assert_allclose([r["loss"] for r in thist],
                               [r["loss"] for r in jhist], rtol=BF16_RTOL)
    _hold_sgd(ref_state, ts, BF16_RTOL)


def test_trained_weights_load_into_a_fresh_module():
    """``variables_of`` is the state dict of the trained module: a fresh
    module loaded with it answers as the trainer's eval step."""
    _, _, _, ts, tt = _fit_both("stack", "sgd", 0.1, epochs=1)
    fresh = PortStack()
    fresh.load_state_dict(tt.variables_of(ts))
    x = torch.from_numpy(_data(12, 4)[0][0]).float()
    with torch.no_grad():
        assert torch.equal(fresh.eval()(x), tt.make_eval_step()(ts, x))
