"""The port's optimizers and losses against optax and the JAX package.

Each of the 7 named optimizers (``make_optimizer``, the reference's
default learning rates, built through ``optax.inject_hyperparams``) and
the port's counterpart take 3 steps from the same numpy params and
gradients; the params and moments are held after every step. Each loss
(probabilities and logit forms, rank alignment) and ``accuracy_metric``
are held against the reference on the same inputs.

Tolerances: params after each step max|Δ| ≤ 1e-6·max(1, max|ref|)
(float32 elementwise rules in the same op order; ``rsqrt``/``pow`` may
round differently in their last bit, which the step size scales down);
losses within rtol 1e-6; accuracies exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.train import optimizers as jopt
from sparkdl_tpu_torch.train import optimizers as topt

PARAM_RTOL = 1e-6
LOSS_RTOL = 1e-6
NAMES = ["sgd", "adam", "adamw", "rmsprop", "adagrad", "nadam", "adamax"]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "s": np.float32(rng.normal(size=()))}


def _grads(step, seed=1):
    rng = np.random.default_rng(seed + step)
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32),
         "s": np.float32(rng.normal(size=()))}
    g["b"][0] = 0.0  # a zero gradient (adagrad's where, adam's 0/eps)
    return g


def _assert_params(got, ref, what):
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        g = got[k].detach().numpy()
        bound = PARAM_RTOL * max(1.0, float(np.max(np.abs(r))))
        assert float(np.max(np.abs(g - r))) <= bound, (what, k, g, r)


def _run_both(name, lr=None, steps=3, **kwargs):
    p0 = _params()
    tx = jopt.make_optimizer(name, lr, **kwargs)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jp)
    port = topt.make_optimizer(name, lr, **kwargs)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = port.init(tp)
    for step in range(steps):
        g = _grads(step)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        port.apply(tp, {k: torch.tensor(v) for k, v in g.items()}, tstate)
        _assert_params(tp, jax.device_get(jp), f"{name} step {step}")
    return jstate, tstate, tx, port


@pytest.mark.parametrize("name", NAMES)
def test_named_optimizer_three_steps_match_optax(name):
    jstate, tstate, tx, port = _run_both(name)
    assert int(tstate["count"]) == 3
    lr = float(jstate.hyperparams["learning_rate"])
    assert lr == float(tstate["learning_rate"])
    assert lr == float(np.float32(jopt._DEFAULT_LR[name]))
    assert port.learning_rate == topt._DEFAULT_LR[name]


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"momentum": 0.5}),
    ("rmsprop", {"eps_in_sqrt": False, "decay": 0.8}),
    ("adam", {"b1": 0.8, "eps_root": 1e-8}),
    ("adamw", {"weight_decay": 0.05}),
    ("adagrad", {"initial_accumulator_value": 0.0}),
])
def test_optimizer_options_match_optax(name, kwargs):
    _run_both(name, lr=0.05, **kwargs)


def test_learning_rate_lives_in_the_state():
    """One optimizer object, two learning rates: the state's tensor rules
    (``inject_hyperparams``)."""
    port = topt.make_optimizer("sgd", 0.01)
    p = {"w": torch.ones(3)}
    st = port.init(p)
    st["learning_rate"].fill_(0.5)
    port.apply(p, {"w": torch.ones(3)}, st)
    assert torch.equal(p["w"], torch.full((3,), 0.5))


def test_frozen_leaves_get_zero_update_like_multi_transform():
    p0 = _params()
    frozen = {"w": True, "b": False, "s": True}
    labels = {k: "train" if v else "freeze" for k, v in frozen.items()}
    tx = optax.multi_transform(
        {"train": jopt.make_optimizer("adam"),
         "freeze": optax.set_to_zero()}, labels)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jp)
    port = topt.make_optimizer("adam").with_trainable(
        [k for k, v in frozen.items() if v])
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = port.init(tp)
    assert "b" not in tstate["mu"]
    for step in range(3):
        g = _grads(step)
        u, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        port.apply(tp, {k: torch.tensor(v) for k, v in g.items()}, tstate)
        _assert_params(tp, jax.device_get(jp), f"masked step {step}")
    assert np.array_equal(tp["b"].numpy(), p0["b"])


def test_unknown_names_and_options_raise():
    with pytest.raises(ValueError, match="optimizer"):
        topt.make_optimizer("not_an_opt")
    with pytest.raises(ValueError, match="loss"):
        topt.make_loss("not_a_loss")
    with pytest.raises(ValueError, match="takes"):
        topt.make_optimizer("adam", centered=True)
    opt = topt.make_optimizer("adam")
    assert topt.make_optimizer(opt) is opt
    assert topt._DEFAULT_LR == jopt._DEFAULT_LR
    assert topt._EPS == jopt._EPS


def _probs(shape, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape).astype(np.float32) * 2
    return logits, np.array(jax.nn.softmax(logits, axis=-1))


def _loss_cases():
    logits, probs = _probs((6, 4), 3)
    ids = np.random.default_rng(4).integers(0, 4, size=6)
    onehot = np.eye(4, dtype=np.float32)[ids]
    probs[0, 1] = 0.0          # clipped at _EPS
    rng = np.random.default_rng(5)
    bin_logits = rng.normal(size=(6, 1)).astype(np.float32)
    bin_probs = np.array(jax.nn.sigmoid(bin_logits))
    bin_labels = (rng.random(6) > 0.5).astype(np.float32)
    reg = rng.normal(size=(6, 1)).astype(np.float32)
    return [
        ("categorical_crossentropy", False, probs, onehot),
        ("categorical_crossentropy", True, logits, onehot),
        ("sparse_categorical_crossentropy", False, probs, ids),
        ("sparse_categorical_crossentropy", True, logits, ids),
        ("binary_crossentropy", False, bin_probs, bin_labels),
        ("binary_crossentropy", False, bin_probs, bin_labels[:, None]),
        ("binary_crossentropy", True, bin_logits, bin_labels),
        ("mse", False, reg, bin_labels),
        ("mean_squared_error", False, reg[:, 0], bin_labels[:, None]),
        ("mae", False, reg, bin_labels),
        ("mean_absolute_error", False, reg, bin_labels[:, None]),
    ]


@pytest.mark.parametrize("case", range(11))
def test_loss_matches_reference(case):
    cases = _loss_cases()
    assert len(cases) == 11
    name, from_logits, out, labels = cases[case]
    ref = float(jopt.make_loss(name, from_logits)(jnp.asarray(out),
                                                  jnp.asarray(labels)))
    got = topt.make_loss(name, from_logits)(torch.from_numpy(np.array(out)),
                                           torch.from_numpy(np.array(labels)))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, rtol=LOSS_RTOL)


def test_one_hot_labels_cannot_feed_a_sigmoid_head():
    with pytest.raises(ValueError, match="1-unit"):
        topt.make_loss("binary_crossentropy")(torch.rand(4, 1),
                                              torch.eye(2)[[0, 1, 0, 1]])


@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("head,labels", [
    (1, "ids"), (1, "onehot"), (1, "column"), (4, "ids"), (4, "onehot")])
def test_accuracy_metric_matches_reference(head, labels, from_logits):
    rng = np.random.default_rng(head)
    out = rng.normal(size=(8, head)).astype(np.float32)
    if head == 1 and not from_logits:
        out = 1 / (1 + np.exp(-out))
    classes = max(head, 2)
    ids = rng.integers(0, classes, size=8)
    if labels == "ids":
        y = ids.astype(np.float32)
    elif labels == "onehot":
        y = np.eye(classes, dtype=np.float32)[ids]
    else:
        y = ids[:, None].astype(np.float32)
    ref = float(jopt.accuracy_metric(jnp.asarray(out), jnp.asarray(y),
                                     from_logits=from_logits))
    got = topt.accuracy_metric(torch.from_numpy(out), torch.from_numpy(y),
                               from_logits=from_logits)
    assert float(got) == ref
