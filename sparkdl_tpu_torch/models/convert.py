"""Weight bridge: the JAX package's Flax variables → a PyTorch state dict.

``from_flax_variables(name, variables)`` takes a ``{"params",
"batch_stats"}`` tree (nested dicts of numpy arrays, or anything
``np.asarray`` reads) and returns the state dict of the port's module of
the same name:

- conv kernel HWIO → OIHW (a depthwise ``(3, 3, 1, C)`` becomes
  ``(C, 1, 3, 3)`` by the same transpose), a conv's ``bias`` kept;
- Dense kernel ``(in, out)`` → ``(out, in)``;
- BN ``scale``/``bias`` → ``weight``/``bias`` and ``batch_stats``
  ``mean``/``var`` → ``running_mean``/``running_var``.

Module paths keep the Flax names, joined with dots.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_NAMES = {"scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a float32 CPU tensor (a copy only where ``a`` is not
    already a writable, contiguous float32 array)."""
    return torch.from_numpy(np.require(a, np.float32, ["C", "W"]))


def _kernel(a: np.ndarray) -> torch.Tensor:
    """The layout change by torch's blocked, threaded copy: numpy's
    transposed copy of a VGG ``fc1`` kernel (25,088 × 4,096) takes
    seconds."""
    if a.ndim == 4:          # HWIO → OIHW
        return _tensor(a).permute(3, 2, 0, 1).contiguous()
    if a.ndim == 2:          # (in, out) → (out, in)
        return _tensor(a).t().contiguous()
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def from_flax_variables(name: str, variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``name`` model from Flax variables."""
    if "params" not in variables:
        raise ValueError(
            f"{name}: expected a Flax variables tree with a 'params' "
            f"collection, got keys {sorted(variables)}")
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        *mod, leaf_name = path
        if leaf_name == "kernel":
            key, value = "weight", _kernel(leaf)
        elif leaf_name in _PARAM_NAMES:
            key, value = _PARAM_NAMES[leaf_name], _tensor(leaf)
        else:
            raise ValueError(f"{name}: unknown parameter {'/'.join(path)}")
        state[".".join(mod + [key])] = value
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mod, leaf_name = path
        if leaf_name not in _STAT_NAMES:
            raise ValueError(f"{name}: unknown statistic {'/'.join(path)}")
        state[".".join(mod + [_STAT_NAMES[leaf_name]])] = _tensor(leaf)
    return state
