"""ModelFunction — the model abstraction at the center of the framework.

A port of ``sparkdl_tpu.core.model_function``: *an apply function + its
weights + an input spec*. Here the weights are an ``nn.Module`` and
``apply_fn(module, x)`` runs it eagerly on NHWC tensors; composition
(``with_preprocess``, ``with_postprocess``, ``resized``, ``flattened``,
``with_compute_dtype``) is function composition, exactly as in the JAX
package, so the dtype flow of each wrapper is the reference's.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.core import batching, kernels


@dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype contract for one model input; dim 0 None = batch."""

    shape: Tuple[Optional[int], ...]
    dtype: str = "float32"

    def spatial_size(self) -> Optional[Tuple[int, int]]:
        """(H, W) for a static NHWC spec; None when not image-shaped."""
        if len(self.shape) == 4 and None not in self.shape[1:3]:
            return (self.shape[1], self.shape[2])
        return None


#: Inference precisions :meth:`ModelFunction.with_dtype` accepts (int8
#: post-training quantization is not ported yet).
PRECISIONS = ("float32", "bfloat16")


def torch_dtype(name) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/``"uint8"`` or a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "uint8": torch.uint8}[str(name)]


class ModelFunction:
    """``apply_fn(variables, x) -> y`` + ``variables`` (an ``nn.Module``,
    or None for a weightless function) + input spec."""

    #: True when the registry selected an inference-specialized fast apply
    #: (``models/*_fast.py``); set after construction by the registry.
    fast_path = False

    #: True when running this model can consult a kernel route
    #: (``core/kernels.py``): set by :meth:`fromModule` (the layers' kernel
    #: families) and :meth:`resized` (the preproc route), carried by every
    #: wrapper. Gates the autotune pass of :meth:`apply_batch`, which runs
    #: the body once more on meta tensors: an arbitrary ``fromFunction``
    #: callable has no routes and is not run twice.
    kernel_routable = False

    def __init__(self, apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 variables: Any, input_spec: TensorSpec,
                 name: str = "model") -> None:
        self.apply_fn = apply_fn
        self.variables = variables
        self.input_spec = input_spec
        self.name = name
        self._flat_cache: Optional["ModelFunction"] = None
        self._resize_cache: Dict[Tuple, "ModelFunction"] = {}
        self._precision_cache: Dict[str, "ModelFunction"] = {}
        self._autotuned_shapes: set = set()

    @classmethod
    def fromFunction(cls, fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     variables: Any, input_spec: TensorSpec,
                     name: str = "fn") -> "ModelFunction":
        """From a function ``fn(variables, x)`` over any tensors, e.g. an
        ``nn.Module``'s (the ``TFInputGraph.fromGraph`` analog)."""
        return cls(fn, variables, input_spec, name=name)

    @classmethod
    def fromModule(cls, module: torch.nn.Module, input_spec: TensorSpec,
                   name: Optional[str] = None) -> "ModelFunction":
        """From an ``nn.Module`` run in eval mode (the ``fromFlax`` analog)."""
        module.eval()
        out = cls(lambda m, x: m(x), module, input_spec,
                  name=name or type(module).__name__)
        out.kernel_routable = True
        return out

    # -- composition ---------------------------------------------------------

    def with_preprocess(self, pre: Callable[[torch.Tensor], torch.Tensor],
                        input_spec: Optional[TensorSpec] = None
                        ) -> "ModelFunction":
        """``apply(vars, pre(x))``."""
        apply_fn = self.apply_fn

        def fn(vs, x):
            return apply_fn(vs, pre(x))

        out = ModelFunction(fn, self.variables,
                            input_spec or self.input_spec, name=self.name)
        out.kernel_routable = self.kernel_routable
        return out

    def with_postprocess(self, post: Callable[[torch.Tensor], torch.Tensor]
                         ) -> "ModelFunction":
        apply_fn = self.apply_fn

        def fn(vs, x):
            return post(apply_fn(vs, x))

        out = ModelFunction(fn, self.variables, self.input_spec,
                            name=self.name)
        out.kernel_routable = self.kernel_routable
        return out

    def with_compute_dtype(self, dtype) -> "ModelFunction":
        """Run in ``dtype``: float weights cast once here (on a copy of the
        module), the input cast before the body, the output cast back to
        float32 — ``sparkdl_tpu``'s ``with_compute_dtype``. A wrapper that
        casts inside its own body (``resized`` casts to its spec's float32)
        then runs the layers after it in float32 with weights rounded to
        ``dtype``, as the reference does. The result is not
        :attr:`kernel_routable`, as in the reference: under the default
        bf16 precision no site is collected, auditioned or routed."""
        dtype = torch_dtype(dtype)
        apply_fn = self.apply_fn
        variables = self.variables
        if isinstance(variables, torch.nn.Module):
            variables = copy.deepcopy(variables).to(dtype)

        def fn(vs, x):
            return apply_fn(vs, x.to(dtype)).float()

        return ModelFunction(fn, variables, self.input_spec, name=self.name)

    def with_dtype(self, precision: str) -> "ModelFunction":
        """The precision knob (``EngineConfig.inference_precision`` applies
        it at the executor). ``"float32"`` returns ``self``; ``"bfloat16"``
        is :meth:`with_compute_dtype`. Memoized per precision."""
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}")
        if precision == "float32":
            return self
        out = self._precision_cache.get(precision)
        if out is None:
            out = self.with_compute_dtype(precision)
            self._precision_cache[precision] = out
        return out

    def flattened(self) -> "ModelFunction":
        """Outputs flattened to (batch, -1) — the ``buildFlattener`` analog.
        Memoized, so its precision variants are built once."""
        if self._flat_cache is None:
            self._flat_cache = self.with_postprocess(
                lambda y: y.reshape(y.shape[0], -1))
        return self._flat_cache

    def resized(self, src_size: Tuple[int, int],
                target_size: Optional[Tuple[int, int]] = None
                ) -> "ModelFunction":
        """Model preceded by an ON-DEVICE bilinear resize from (H, W)
        inputs — the ``preproc_resize`` site. The input is cast to the
        spec's dtype and resized (half-pixel centres, no antialias) by
        ``kernels.route_preproc`` where the kernel gate routes the site,
        else by its twin (cast + ``F.interpolate``), the reference's XLA
        pair. Memoized per (src, target)."""
        target = (tuple(target_size) if target_size is not None
                  else self.input_spec.spatial_size())
        if target is None or tuple(src_size) == target:
            return self
        key = (tuple(src_size), target)
        if key not in self._resize_cache:
            th, tw = target
            out_dtype = torch_dtype(self.input_spec.dtype)
            family = self.name

            def pre(x):
                fused = kernels.route_preproc(x, (th, tw), out_dtype,
                                              family=family)
                if fused is not None:
                    return fused
                return kernels.twin_preproc(x, (th, tw), out_dtype)

            spec = TensorSpec((None, int(src_size[0]), int(src_size[1]),
                               self.input_spec.shape[3]),
                              self.input_spec.dtype)
            wrapped = self.with_preprocess(pre, input_spec=spec)
            # pre() consults route_preproc whatever the parent's body holds
            wrapped.kernel_routable = True
            self._resize_cache[key] = wrapped
        return self._resize_cache[key]

    # -- execution -----------------------------------------------------------

    def to(self, device) -> "ModelFunction":
        """Move the weights to ``device`` (in place; a no-op when there)."""
        if isinstance(self.variables, torch.nn.Module):
            self.variables.to(device)
        return self

    def stage_inputs(self, array) -> np.ndarray:
        """Host-side staging cast: uint8 stays uint8 (the device casts,
        a quarter of the upload bytes); anything else is cast to the spec
        dtype."""
        arr = np.asarray(array)
        if arr.dtype != np.uint8 and arr.dtype != np.dtype(
                self.input_spec.dtype):
            arr = arr.astype(self.input_spec.dtype)
        return arr

    def apply_batch(self, array, batch_size: int = 64,
                    device="cuda") -> np.ndarray:
        """Run over N rows in padded chunks on ``device``; returns numpy.
        Each chunk is uploaded with one host-to-device copy from a pinned
        buffer (``core.batching.run_batched``) and cast on the device to
        the spec dtype before the body runs, as the JAX package's compiled
        program does. At the first sight of a chunk's (shape, dtype,
        device), a kernel-routable model settles its kernel verdicts first
        (``kernels.ensure_autotuned``: under ``"autotune"``, an abstract
        pass and at most one audition per new site), so the chunk runs
        against decided sites."""
        device = torch.device(device)
        array = self.stage_inputs(array)
        self.to(device)
        spec_dtype = torch_dtype(self.input_spec.dtype)

        def run(x):
            x = x.to(spec_dtype)
            key = (tuple(x.shape), x.dtype, x.device)
            if (self.kernel_routable and key not in self._autotuned_shapes
                    and kernels.kernel_mode() == "autotune"):
                kernels.ensure_autotuned(self, x, model=self.name,
                                         variables=self.variables)
                self._autotuned_shapes.add(key)
            return self(x)

        return batching.run_batched(run, array, batch_size, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.variables, x)

    def __repr__(self) -> str:
        return (f"ModelFunction({self.name}, input={self.input_spec.shape} "
                f"{self.input_spec.dtype})")
