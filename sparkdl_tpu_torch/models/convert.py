"""Weight bridge: the JAX package's Flax variables → a PyTorch state dict.

``from_flax_variables(name, variables)`` takes a ``{"params",
"batch_stats"}`` tree (nested dicts of numpy arrays, or anything
``np.asarray`` reads) and returns the state dict of the port's module of
the same name:

- conv kernel HWIO → OIHW (a depthwise ``(3, 3, 1, C)`` becomes
  ``(C, 1, 3, 3)`` by the same transpose);
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


def _kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:          # HWIO → OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:          # (in, out) → (out, in)
        return a.T
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
            key, arr = "weight", _kernel(leaf)
        elif leaf_name in _PARAM_NAMES:
            key, arr = _PARAM_NAMES[leaf_name], leaf
        else:
            raise ValueError(f"{name}: unknown parameter {'/'.join(path)}")
        state[".".join(mod + [key])] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mod, leaf_name = path
        if leaf_name not in _STAT_NAMES:
            raise ValueError(f"{name}: unknown statistic {'/'.join(path)}")
        state[".".join(mod + [_STAT_NAMES[leaf_name]])] = torch.from_numpy(
            np.ascontiguousarray(leaf, dtype=np.float32))
    return state
