"""Models and loaders the cluster serving tests deploy to worker processes.

They live here, in a module that imports neither JAX nor the JAX
package, because a worker imports the module of every function it is
sent (``cluster/transport.py``): a loader defined in a test module would
drag JAX into each replica.
"""

import multiprocessing

import numpy as np
import torch

from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec

ELEMENT = (6,)
FEATURES = 3


def _tanh_matmul(vs, x):
    return torch.tanh(x @ vs)


def toy_weights(scale: float) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(
        (rng.normal(size=(ELEMENT[0], FEATURES)) * scale).astype(np.float32))


def toy(scale: float, name: str = "served") -> ModelFunction:
    """Row-wise ``tanh(x @ w)``, ``w`` seeded and scaled by ``scale``."""
    return ModelFunction(_tanh_matmul, toy_weights(scale),
                         TensorSpec((None,) + ELEMENT), name=name)


def reference(scale: float, rows: np.ndarray) -> np.ndarray:
    """The toy model's forward of ``rows`` in this process, eagerly."""
    return torch.tanh(torch.from_numpy(rows) @ toy_weights(scale)).numpy()


def toy_loader(scale: float):
    """A loader of :func:`toy` that builds the model where it runs."""
    def load():
        return toy(scale)

    return load


def refusing_loader(scale: float):
    """:func:`toy_loader`, except in the cluster worker whose process name
    ends in ``-1``, where the weights refuse to load."""
    def load():
        if multiprocessing.current_process().name.endswith("-1"):
            raise RuntimeError("v2 weights refuse to load here")
        return toy(scale)

    return load


def _explode(vs, x):
    raise RuntimeError("v2 cannot execute its ladder")


def dud_loader():
    """A model that loads everywhere and fails at its first forward."""
    return ModelFunction(_explode, torch.zeros(1),
                         TensorSpec((None,) + ELEMENT), name="served")


def testnet_loader(weights=None, seed: int = 0):
    """The port's TestNet featurizer, from flax ``weights`` (converted by
    ``models/convert.py``) or, with ``weights=None``, seeded by ``seed``,
    built where the loader runs."""
    def load():
        from sparkdl_tpu_torch.models import registry

        if weights is None:
            return registry.build_featurizer("TestNet", seed=seed)
        return registry.build_featurizer("TestNet", weights=weights)

    return load


def state_of(loader):
    """An op that runs ``loader`` in the process it is sent to and gives,
    in a list column of one cell, the state dict of the model it built
    (each tensor as a CPU numpy array)."""
    def op(batch):
        model = loader()
        state = {k: t.detach().cpu().numpy()
                 for k, t in model.variables.state_dict().items()}
        return [state] * batch.num_rows

    return op
