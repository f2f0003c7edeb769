"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Weights come from numpy with a fixed seed, shaped by the JAX module's own
variables tree (``jax.eval_shape`` of its ``init``: tracing only, no
compile), and cross to the port through ``from_flax_variables``. The BN
statistics are drawn away from their init values (γ≠1, β≠0, mean≠0,
var≠1), so a BN parameter mapped to the wrong place shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu_torch.image import imageIO


def random_variables(module, input_shape, seed: int = 0):
    """A ``{"params", "batch_stats"}`` tree of numpy arrays for ``module``."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros(input_shape, jnp.float32)))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        leaf = path[-1].key
        shape = sd.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf == "scale":
            return (np.abs(rng.normal(size=shape)) + 0.5).astype(np.float32)
        if leaf in ("bias", "mean"):
            return (rng.normal(size=shape) * 0.1).astype(np.float32)
        if leaf == "var":
            return (np.abs(rng.normal(size=shape)) + 1.0).astype(np.float32)
        raise ValueError(f"unexpected variable {path}")

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, _plain(tree))


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def headless(variables):
    """The featurizer's part of a full (include_top) model's tree (BN-free
    models such as VGG and TestNet have no ``batch_stats``)."""
    out = {"params": {k: v for k, v in variables["params"].items()
                      if k != "predictions"}}
    if "batch_stats" in variables:
        out["batch_stats"] = variables["batch_stats"]
    return out


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def frames(arrays, origins):
    """One image column of ``arrays`` as a frame of each package: the JAX
    package's and the port's."""
    jdf = sparkdl_tpu.DataFrame.fromArrow(pa.table(
        {"image": jax_imageIO.imageArraysToStructColumn(arrays, origins)}))
    tdf = sparkdl_tpu_torch.DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(arrays, origins)})
    return jdf, tdf


def column(featurizer, frame, name: str) -> np.ndarray:
    """The vectors of column ``name`` after ``featurizer.transform``."""
    return np.stack([np.asarray(r[name], np.float32)
                     for r in featurizer.transform(frame).collect()])
