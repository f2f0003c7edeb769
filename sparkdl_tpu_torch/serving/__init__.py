"""Online serving plane.

A port of ``sparkdl_tpu.serving``, the row-level front end over the
executor choke point: a :class:`~sparkdl_tpu_torch.serving.server.
ModelServer` serves single rows and small batches through
``core.executor.execute`` with SLO-aware admission; a
:class:`~sparkdl_tpu_torch.serving.registry.ModelRegistry` holds
versioned deployments with shadow traffic, atomic cutover and rollback;
a :class:`~sparkdl_tpu_torch.serving.residency.ResidencyManager` keeps
many models resident on the card under a byte budget with LRU/weighted
eviction, pinning, and ``sparkdl.model_load`` cold-start spans.

The reference's cluster serving plane (replicated deployments across
worker processes) is not ported yet: its names resolve lazily here, as
in the reference, and raise ``NotImplementedError``.
"""

from sparkdl_tpu_torch.serving.registry import (  # noqa: F401
    Deployment,
    ModelRegistry,
    default_registry,
)
from sparkdl_tpu_torch.serving.residency import (  # noqa: F401
    ResidencyExhausted,
    ResidencyManager,
)
from sparkdl_tpu_torch.serving.server import (  # noqa: F401
    ModelServer,
    PredictResult,
    ServingOverloaded,
)

# the lazy cluster names stay out of __all__: a star import would raise
__all__ = [
    "Deployment",
    "ModelRegistry",
    "ModelServer",
    "PredictResult",
    "ResidencyExhausted",
    "ResidencyManager",
    "ServingOverloaded",
    "default_registry",
]

_LAZY_CLUSTER = ("ClusterServingRouter", "CutoverFailed",
                 "WorkerServingPlane")


def __getattr__(name):
    if name in _LAZY_CLUSTER:
        raise NotImplementedError(
            f"sparkdl_tpu_torch.serving.{name} belongs to the cluster "
            "serving plane (serving/cluster.py), which is not yet ported "
            "to sparkdl_tpu_torch")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
