"""Keras-name → optimizer/loss registry, with optax's update rules.

A port of ``sparkdl_tpu.train.optimizers``. The reference lowers the
Keras names onto optax; here each named optimizer is optax's update rule
written on tensors (``torch.optim``'s defaults and rules differ: its
RMSprop decays by 0.99 and adds eps outside the root, its Adagrad starts
its accumulator at 0 with eps 1e-10, its AdamW decays weights by 1e-2,
its NAdam adds a momentum-decay schedule and its Adamax places eps
elsewhere). The learning rate is a float32 tensor in the optimizer state
(``optax.inject_hyperparams``), so one step serves every learning rate.

State and updates run in place: :meth:`Optimizer.apply` moves the params
and the state of one step, inside ``torch.no_grad``, with no host sync.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterable, Optional, Union

import torch

Params = Dict[str, torch.Tensor]

_DEFAULT_LR = {"sgd": 0.01, "adam": 1e-3, "adamw": 1e-3, "rmsprop": 1e-3,
               "adagrad": 1e-2, "nadam": 1e-3, "adamax": 1e-3}

# each name's keyword arguments and optax's defaults for them
_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "sgd": {"momentum": None, "nesterov": False},
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
             "nesterov": False},
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
              "weight_decay": 1e-4, "nesterov": False},
    "nadam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
              "nesterov": True},
    "rmsprop": {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                "eps_in_sqrt": True, "momentum": None, "nesterov": False},
    "adagrad": {"initial_accumulator_value": 0.1, "eps": 1e-7},
    "adamax": {"b1": 0.9, "b2": 0.999, "eps": 1e-8},
}


def _bias_correction(moment: torch.Tensor, decay: float,
                     count: torch.Tensor) -> torch.Tensor:
    """optax's ``tree_bias_correction``: ``moment / (1 − decay^count)``,
    the power taken in float32."""
    return moment / (1 - torch.pow(decay, count.float()))


def _trace(g: torch.Tensor, t: torch.Tensor, decay: float,
           nesterov: bool) -> torch.Tensor:
    """optax's ``trace``: ``t ← g + decay·t`` in place; the update is the
    new trace, or ``g + decay·t`` again under Nesterov."""
    t.copy_(g + decay * t)
    return g + decay * t if nesterov else t


class Optimizer:
    """One named optimizer: optax's rule over a dict of named tensors.

    ``init(params)`` → state (``count``, ``learning_rate``, the rule's
    slots, each a dict keyed like ``params``); ``apply(params, grads,
    state)`` moves both one step in place. ``trainable``: the names that
    train; every other param gets a zero update and no slots
    (``optax.multi_transform`` with ``set_to_zero``). None: all train.
    """

    def __init__(self, name: str, learning_rate: float,
                 trainable: Optional[Iterable[str]] = None,
                 **kwargs) -> None:
        defaults = _DEFAULTS[name]
        unknown = set(kwargs) - set(defaults)
        if unknown:
            raise ValueError(
                f"optimizer {name!r} takes {sorted(defaults)}; got "
                f"{sorted(unknown)}")
        self.name = name
        self.learning_rate = float(learning_rate)
        self.hyper = {**defaults, **kwargs}
        self.trainable = None if trainable is None else set(trainable)

    def with_trainable(self, trainable: Iterable[str]) -> "Optimizer":
        """This optimizer with only ``trainable`` training."""
        out = copy.copy(self)
        out.trainable = set(trainable)
        return out

    def _names(self, params: Params):
        return [n for n in params
                if self.trainable is None or n in self.trainable]

    def init(self, params: Params) -> Dict[str, Any]:
        names = self._names(params)
        some = next(iter(params.values()))
        state: Dict[str, Any] = {
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
            "learning_rate": torch.tensor(self.learning_rate,
                                          dtype=torch.float32,
                                          device=some.device)}
        h = self.hyper

        def like(fill: float) -> Params:
            return {n: torch.full_like(params[n], fill) for n in names}

        if self.name in ("adam", "adamw", "nadam", "adamax"):
            state["mu"], state["nu"] = like(0.0), like(0.0)
        elif self.name == "rmsprop":
            state["nu"] = like(h["initial_scale"])
            if h["momentum"] is not None:
                state["trace"] = like(0.0)
        elif self.name == "adagrad":
            state["sum_of_squares"] = like(h["initial_accumulator_value"])
        elif self.name == "sgd" and h["momentum"] is not None:
            state["trace"] = like(0.0)
        return state

    @torch.no_grad()
    def apply(self, params: Params, grads: Dict[str, Optional[torch.Tensor]],
              state: Dict[str, Any]) -> None:
        """One step: ``p ← p + u`` for each trainable param, ``u`` the
        rule's update scaled by ``−learning_rate`` (a missing gradient
        counts as zero, as a gradient of an unused param is in JAX)."""
        h = self.hyper
        count = state["count"].add_(1)
        step = -1 * state["learning_rate"]
        for n in self._names(params):
            p = params[n]
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(p)
            u = step * self._update(n, g.to(p.dtype), p, state, count, h)
            if self.name == "rmsprop" and h["momentum"] is not None:
                # optax.rmsprop traces after scaling by the learning rate
                u = _trace(u, state["trace"][n], h["momentum"],
                           h["nesterov"])
            p.copy_(p + u)

    def _update(self, n, g, p, state, count, h) -> torch.Tensor:
        name = self.name
        if name in ("adam", "adamw", "nadam"):
            mu, nu = state["mu"][n], state["nu"][n]
            b1, b2 = h["b1"], h["b2"]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            if h["nesterov"]:
                mu_hat = (b1 * _bias_correction(mu, b1, count + 1)
                          + (1 - b1) * _bias_correction(g, b1, count))
            else:
                mu_hat = _bias_correction(mu, b1, count)
            nu_hat = _bias_correction(nu, b2, count)
            u = mu_hat / (torch.sqrt(nu_hat + h["eps_root"]) + h["eps"])
            if name == "adamw":
                u = u + h["weight_decay"] * p
            return u
        if name == "adamax":
            mu, nu = state["mu"][n], state["nu"][n]
            mu.copy_((1 - h["b1"]) * g + h["b1"] * mu)
            nu.copy_(torch.maximum(torch.abs(g) + h["eps"], h["b2"] * nu))
            return _bias_correction(mu, h["b1"], count) / nu
        if name == "rmsprop":
            nu = state["nu"][n]
            nu.copy_((1 - h["decay"]) * (g * g) + h["decay"] * nu)
            if h["eps_in_sqrt"]:
                return torch.rsqrt(nu + h["eps"]) * g
            return 1 / (torch.sqrt(nu) + h["eps"]) * g
        if name == "adagrad":
            sos = state["sum_of_squares"][n]
            sos.copy_(g * g + sos)
            inv = torch.where(sos > 0, torch.rsqrt(sos + h["eps"]),
                              torch.zeros_like(sos))
            return inv * g
        # sgd
        if h["momentum"] is not None:
            return _trace(g, state["trace"][n], h["momentum"],
                          h["nesterov"])
        return g


def make_optimizer(name_or_opt: Union[str, Optimizer],
                   learning_rate: Optional[float] = None,
                   **kwargs) -> Optimizer:
    """Resolve a keras-style optimizer name (or pass an
    :class:`Optimizer` through), with the reference's default learning
    rate per name."""
    if not isinstance(name_or_opt, str):
        return name_or_opt
    name = name_or_opt.lower()
    if name not in _DEFAULTS:
        raise ValueError(
            f"Unsupported optimizer {name_or_opt!r}; supported: "
            f"{sorted(_DEFAULTS)}")
    lr = learning_rate if learning_rate is not None else _DEFAULT_LR[name]
    return Optimizer(name, lr, **kwargs)


# -- losses ------------------------------------------------------------------
# Each: fn(outputs, labels) -> scalar mean loss. Outputs follow the keras
# convention for the matching loss (probabilities for *_crossentropy, since
# keras models end in softmax/sigmoid activations; see from_logits below).

_EPS = 1e-7


def _align_ranks(outputs: torch.Tensor, labels):
    """keras ``squeeze_or_expand_dimensions``: (N,) labels against an
    (N, 1) head never broadcast to (N, N); (N, k>1) labels against a
    1-unit head raise."""
    labels = torch.as_tensor(labels, device=outputs.device)
    if (outputs.dim() == labels.dim() and outputs.shape[-1] == 1
            and labels.shape[-1] > 1):
        raise ValueError(
            f"labels with trailing dim {labels.shape[-1]} cannot feed a "
            "1-unit (sigmoid) head; pass (N,) 0/1 labels or argmax the "
            "one-hot")
    if labels.dim() == outputs.dim() - 1 and outputs.shape[-1] == 1:
        labels = labels[..., None]
    elif outputs.dim() == labels.dim() - 1 and labels.shape[-1] == 1:
        outputs = outputs[..., None]
    return outputs, labels


def _categorical_crossentropy(probs, labels):
    probs = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -torch.mean(torch.sum(labels * torch.log(probs), dim=-1))


def _sparse_categorical_crossentropy(probs, labels):
    probs = torch.clamp(probs, _EPS, 1.0 - _EPS)
    labels = torch.as_tensor(labels, device=probs.device)
    ll = torch.gather(torch.log(probs), -1, labels[..., None].long())
    return -torch.mean(ll)


def _binary_crossentropy(probs, labels):
    probs, labels = _align_ranks(probs, labels)
    probs = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -torch.mean(labels * torch.log(probs)
                       + (1.0 - labels) * torch.log(1.0 - probs))


def _mse(outputs, labels):
    outputs, labels = _align_ranks(outputs, labels)
    return torch.mean((outputs - labels) ** 2)


def _mae(outputs, labels):
    outputs, labels = _align_ranks(outputs, labels)
    return torch.mean(torch.abs(outputs - labels))


_LOSSES = {
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mse": _mse,
    "mean_squared_error": _mse,
    "mae": _mae,
    "mean_absolute_error": _mae,
}


def _softmax_ce_logits(logits, labels):
    """``optax.softmax_cross_entropy``: −Σ labels·log_softmax."""
    return (-(labels * torch.log_softmax(logits, dim=-1)).sum(-1)).mean()


def _sparse_softmax_ce_logits(logits, labels):
    """``optax.softmax_cross_entropy_with_integer_labels``:
    logsumexp − the label's logit."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    label_logits = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - label_logits).mean()


def _sigmoid_bce_logits(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``."""
    logits, labels = _align_ranks(logits, labels)
    labels = labels.to(logits.dtype)
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    return (-labels * log_p - (1.0 - labels) * log_not_p).mean()


_LOGIT_LOSSES = {
    "categorical_crossentropy": _softmax_ce_logits,
    "sparse_categorical_crossentropy": _sparse_softmax_ce_logits,
    "binary_crossentropy": _sigmoid_bce_logits,
}


def make_loss(name_or_fn: Union[str, Callable],
              from_logits: bool = False) -> Callable:
    """Resolve a keras-style loss name (or pass through a callable).

    ``from_logits=True`` swaps in the numerically-stable fused logit form
    (use when the model's head has no terminal activation).
    """
    if not isinstance(name_or_fn, str):
        return name_or_fn
    name = name_or_fn.lower()
    table = _LOGIT_LOSSES if from_logits and name in _LOGIT_LOSSES else _LOSSES
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"Unsupported loss {name_or_fn!r}; supported: "
            f"{sorted(_LOSSES)}") from None


def accuracy_metric(outputs: torch.Tensor, labels,
                    from_logits: bool = False) -> torch.Tensor:
    """Top-1 accuracy (a float32 scalar on the outputs' device); labels
    may be one-hot or integer class ids.

    Binary heads (``outputs.shape[-1] == 1``) threshold the probability at
    0.5 — or the logit at 0 when ``from_logits`` — instead of argmax (which
    would always predict class 0); (N, k) one-hot labels argmax to class
    ids there, never read as the class-0 indicator."""
    labels = torch.as_tensor(labels, device=outputs.device)
    if outputs.shape[-1] == 1:
        threshold = 0.0 if from_logits else 0.5
        pred = (outputs[..., 0] >= threshold).float()
        if labels.dim() == outputs.dim():
            labels = (labels[..., 0] if labels.shape[-1] == 1
                      else torch.argmax(labels, dim=-1))
        return (pred == labels.float()).float().mean()
    pred = torch.argmax(outputs, dim=-1)
    if labels.dim() == outputs.dim():
        labels = torch.argmax(labels, dim=-1)
    return (pred == labels).float().mean()
