"""Debug hardening: NaN checking for the port.

A port of ``sparkdl_tpu.core.debug``. The reference packages JAX's
``jax_debug_nans`` (every primitive re-checked; a NaN raises
``FloatingPointError`` at the op that produced it) and
``jax_check_tracer_leaks``. Here:

- ``debug_mode(nans=True)`` checks the output of every ATen operator run
  on this thread (a ``TorchDispatchMode``): the first non-finite float
  output raises ``FloatingPointError`` naming the operator, forward and
  backward alike; and it turns on ``torch.autograd.set_detect_anomaly``,
  so a backward error carries the traceback of the forward op whose
  gradient failed. Each check reads its result back to the host, so a
  checked step is far slower, as the reference's op-by-op mode is.
- ``leaks`` has no PyTorch counterpart (eager PyTorch has no tracers to
  leak); it is accepted and does nothing.
- ``SPARKDL_DEBUG=1`` turns ``debug_mode()`` on around every
  ``Trainer.fit`` (:func:`maybe_debug_mode`); off by default.

Use around a failing fit::

    from sparkdl_tpu_torch.core.debug import debug_mode
    with debug_mode():
        trainer.fit(state, batches)   # raises at the first NaN-producing op
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DEBUG_ENV = "SPARKDL_DEBUG"


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator whose float
    output holds a NaN or an infinity."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta" and t.numel()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"non-finite value in the output of {func} "
                    f"(shape {tuple(t.shape)}, {t.dtype})")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, leaks: bool = True) -> Iterator[None]:
    """Enable NaN checking within the scope, on this thread. ``leaks`` is
    accepted for the reference's signature and does nothing."""
    del leaks  # eager PyTorch has no tracers to leak
    if not nans:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield


def debug_enabled() -> bool:
    return os.environ.get(DEBUG_ENV, "") not in ("", "0")


def maybe_debug_mode():
    """``debug_mode()`` when ``SPARKDL_DEBUG`` is set, else a no-op."""
    return debug_mode() if debug_enabled() else contextlib.nullcontext()
