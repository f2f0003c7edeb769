"""The single device entry point of the inference data plane.

A port of ``sparkdl_tpu.core.executor.execute``: transformers call
:func:`execute` instead of ``model.apply_batch``, and it decides the
precision (``EngineConfig.inference_precision``, applied through
``ModelFunction.with_dtype``) and the device (``EngineConfig.device``)
once, here, and hands ``apply_batch`` the model's bucket planner and the
staging depth. Coalescing, priority lanes, admission and the breaker are
not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sparkdl_tpu_torch.core import batching


def resolve_device() -> torch.device:
    """``EngineConfig.device`` as a torch device. The default is the card;
    asking for it without one raises — the featurize path never falls
    back to the CPU on its own."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    device = torch.device(EngineConfig.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device is {EngineConfig.device!r} but CUDA is not "
            "available (torch.cuda.is_available() is False); set "
            "EngineConfig.device = 'cpu' to run the plain PyTorch versions "
            "on the CPU")
    return device


def execute(model: Any, array: Any, *, batch_size: int = 64,
            prefetch: int = 2) -> np.ndarray:
    """Run ``model`` over the rows of ``array`` on the configured device
    in the configured precision; returns numpy. ``prefetch``: chunk
    staging depth of the async input pipeline (0 = inline); the bucket
    ladder is the model's shared planner under
    ``EngineConfig.bucket_ladder = "tuned"``."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    EngineConfig.validate()
    device = resolve_device()
    if EngineConfig.inference_precision != "float32":
        model = model.with_dtype(EngineConfig.inference_precision)
    planner = batching.default_planner(getattr(model, "name", "model"),
                                       batch_size)
    return model.apply_batch(array, batch_size=batch_size, device=device,
                             prefetch=prefetch, planner=planner)
