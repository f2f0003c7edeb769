"""Core: model functions, batching, the executor and the CUDA kernels.

Exports are lazy (PEP 562), as in the reference: importing
``sparkdl_tpu_torch.core`` loads no submodule (the decode pool's spawned
workers import this package on their way to the image codecs). ``from
sparkdl_tpu_torch.core import executor`` still works through the
submodule import; the names below resolve on first attribute access.
"""

_LAZY_EXPORTS = {
    "ModelFunction": ("sparkdl_tpu_torch.core.model_function",
                      "ModelFunction"),
    "TensorSpec": ("sparkdl_tpu_torch.core.model_function", "TensorSpec"),
    "slo": ("sparkdl_tpu_torch.core", "slo"),
    "durability": ("sparkdl_tpu_torch.core", "durability"),
    "PartitionJournal": ("sparkdl_tpu_torch.core.durability",
                         "PartitionJournal"),
    "telemetry": ("sparkdl_tpu_torch.core", "telemetry"),
    "health": ("sparkdl_tpu_torch.core", "health"),
    "HealthMonitor": ("sparkdl_tpu_torch.core.health", "HealthMonitor"),
    "MetricsRegistry": ("sparkdl_tpu_torch.core.telemetry",
                        "MetricsRegistry"),
    "RunReport": ("sparkdl_tpu_torch.core.telemetry", "RunReport"),
    "SLORule": ("sparkdl_tpu_torch.core.slo", "SLORule"),
    "SLOWatchdog": ("sparkdl_tpu_torch.core.slo", "SLOWatchdog"),
    "SnapshotExporter": ("sparkdl_tpu_torch.core.telemetry",
                         "SnapshotExporter"),
    "Telemetry": ("sparkdl_tpu_torch.core.telemetry", "Telemetry"),
    "Tracer": ("sparkdl_tpu_torch.core.telemetry", "Tracer"),
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'sparkdl_tpu_torch.core' has no attribute {name!r}"
        ) from None
    import importlib

    if module_name == "sparkdl_tpu_torch.core":
        value = importlib.import_module(f"sparkdl_tpu_torch.core.{attr}")
    else:
        value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value
