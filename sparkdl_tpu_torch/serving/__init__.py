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

The cluster serving plane (``serving/cluster.py``: replicated
deployments across the cluster workers, failover, a cluster-atomic
cutover) is exported lazily, as in the reference: touching
:class:`ClusterServingRouter`, :class:`CutoverFailed` or
:class:`WorkerServingPlane` imports it; importing this package does not.
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

__all__ = [
    "ClusterServingRouter",
    "CutoverFailed",
    "Deployment",
    "ModelRegistry",
    "ModelServer",
    "PredictResult",
    "ResidencyExhausted",
    "ResidencyManager",
    "ServingOverloaded",
    "WorkerServingPlane",
    "default_registry",
]

_LAZY_CLUSTER = ("ClusterServingRouter", "CutoverFailed",
                 "WorkerServingPlane")


def __getattr__(name):
    # PEP 562 lazy export: touching a cluster-serving name imports the
    # module; importing the serving package never does
    if name in _LAZY_CLUSTER:
        from sparkdl_tpu_torch.serving import cluster as _cluster

        return getattr(_cluster, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
