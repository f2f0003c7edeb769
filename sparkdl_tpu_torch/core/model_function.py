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
import itertools
import logging
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.core import (
    batching, kernels, profiling, resilience, telemetry,
)

logger = logging.getLogger(__name__)


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


#: Inference precisions :meth:`ModelFunction.with_dtype` accepts, the
#: vocabulary ``EngineConfig.inference_precision`` validates.
PRECISIONS = ("float32", "bfloat16", "int8")

# Marker keys of a quantized leaf of a plain variables tree (a tensor, or
# dicts, lists and tuples of tensors, as ``fromFunction`` takes them): a
# {_Q8_WEIGHTS: int8 tensor, _Q8_SCALE: float32 per-channel scales} dict
# stands in for the float leaf, the reference's markers.
_Q8_WEIGHTS = "__sparkdl_q8_weights__"
_Q8_SCALE = "__sparkdl_q8_scale__"


def _is_q8_leaf(x) -> bool:
    return isinstance(x, dict) and _Q8_WEIGHTS in x


def _channel_shape(ndim: int, axis: int) -> List[int]:
    shape = [1] * ndim
    shape[axis] = -1
    return shape


def _quantize(w: torch.Tensor, axis: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 of ``w`` along ``axis`` (the output
    channel's), in the reference's float32 arithmetic, bit for bit:
    ``scale = max|w| / 127`` over every other axis (a zero scale becomes
    1), ``q = clip(rint(w / scale), -127, 127)``."""
    w = w.detach().float()
    axis %= w.dim()
    scale = w.abs().amax(dim=[d for d in range(w.dim()) if d != axis])
    scale = scale / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(w / scale.reshape(_channel_shape(w.dim(), axis)))
    return q.clamp_(-127, 127).to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                axis: int) -> torch.Tensor:
    """``q · scale`` in bf16, as the reference's ``_dequantize_tree``: one
    elementwise product of the int8 ``q`` (promoted to bf16, exactly) and
    the bf16 scales, so a weight's dequantization reads its int8 once and
    writes one bf16 copy."""
    shape = _channel_shape(q.dim(), axis)
    return q * scale.to(torch.bfloat16).reshape(shape)


def _map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples, a
    quantized leaf taken as one leaf."""
    if isinstance(tree, dict) and not _is_q8_leaf(tree):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a plain tree, a quantized leaf's two tensors among
    them."""
    if _is_q8_leaf(tree):
        return list(tree.values())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _quantize_tree(variables: Any) -> Any:
    """The reference's rule, literally: every float tensor with ndim ≥ 2
    becomes a quantized leaf per its last axis; every other leaf stays as
    it is."""
    def quant(a):
        if not (isinstance(a, torch.Tensor) and a.is_floating_point()
                and a.dim() >= 2):
            return a
        q, scale = _quantize(a, -1)
        return {_Q8_WEIGHTS: q, _Q8_SCALE: scale}

    return _map_tree(quant, variables)


def _dequantize_tree(variables: Any) -> Any:
    """In-forward dequantization of a plain tree: each quantized leaf to
    bf16 (:func:`_dequantize`), each other float tensor cast to bf16, as
    the reference's ``_dequantize_tree``. A module is returned as it is:
    its layers dequantize each weight when they read it
    (:func:`_quantized_module`)."""
    if isinstance(variables, torch.nn.Module):
        return variables

    def deq(a):
        if _is_q8_leaf(a):
            return _dequantize(a[_Q8_WEIGHTS], a[_Q8_SCALE], -1)
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(torch.bfloat16)
        return a

    return _map_tree(deq, variables)


class _DequantizedWeight:
    """Mixin of a quantized layer: ``weight`` is read as the bf16
    dequantization of the int8 buffer ``weight_q8`` by its float32
    per-output-channel ``weight_q8_scale``, computed anew at each read.
    The layer reads it just before it uses it, so a forward (and a graph
    captured over it) keeps one layer's bf16 weight alive at a time, and
    no bf16 copy of the weights stays resident."""

    @property
    def weight(self) -> torch.Tensor:
        return _dequantize(self.weight_q8, self.weight_q8_scale, 0)


_INT8_CLASSES: Dict[type, type] = {}


def _int8_class(cls: type) -> type:
    """``cls`` with :class:`_DequantizedWeight`'s ``weight``: one subclass
    per layer class."""
    return _INT8_CLASSES.setdefault(
        cls, type(f"Int8{cls.__name__}", (_DequantizedWeight, cls), {}))


def _kernel_layers(module: torch.nn.Module) -> List[torch.nn.Module]:
    """The layers holding a Flax ``kernel``: what ``models/convert.py``
    makes from a ``kernel`` leaf is the parameter ``weight`` of a conv or
    dense layer, of ndim ≥ 2 (a BN's ``weight``, from ``scale``, is 1-D).
    Buffers are never kernels."""
    return [m for m in module.modules()
            if isinstance(m._parameters.get("weight"), torch.Tensor)
            and m._parameters["weight"].is_floating_point()
            and m._parameters["weight"].dim() >= 2]


def _quantized_module(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` holding each kernel as int8 per torch axis 0
    (Flax's last axis after the layout change: OIHW's O, a depthwise
    ``(C, 1, 3, 3)``'s C, a dense ``(out, in)``'s out) with its float32
    scales, and every other float tensor in bf16. The float kernels are
    not copied: the copy shares them only until they are quantized."""
    layers = _kernel_layers(module)
    memo = {id(m._parameters["weight"]): m._parameters["weight"]
            for m in layers}
    out = copy.deepcopy(module, memo)
    quantized = []
    for layer in _kernel_layers(out):
        q, scale = _quantize(layer._parameters.pop("weight"), 0)
        quantized.append((layer, q, scale))
    out.to(torch.bfloat16)  # no shared kernel is left to cast in place
    for layer, q, scale in quantized:
        layer.register_buffer("weight_q8", q)
        layer.register_buffer("weight_q8_scale", scale)
        layer.__class__ = _int8_class(type(layer))
    return out


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

    #: The precision :meth:`with_dtype` built this variant for (None for a
    #: model that is not such a variant), carried by every wrapper of it.
    #: A model asked for the precision it already computes in is itself:
    #: casting bf16 weights to bf16 again would only copy them.
    compute_dtype: Optional[str] = None

    def __init__(self, apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 variables: Any, input_spec: TensorSpec,
                 name: str = "model",
                 trainable_mask: Any = None) -> None:
        self.apply_fn = apply_fn
        self.variables = variables
        self.input_spec = input_spec
        self.name = name
        # Optional bools over the weights: a ``{name: bool}`` dict over a
        # module's ``named_parameters()``, or a tree of bools matching a
        # plain ``variables`` tree. False leaves are non-trainable (e.g.
        # an ingested model's frozen layers) and the Trainer zeroes their
        # updates. None = everything trainable.
        self.trainable_mask = trainable_mask
        self._flat_cache: Optional["ModelFunction"] = None
        self._resize_cache: Dict[Tuple, "ModelFunction"] = {}
        self._precision_cache: Dict[str, "ModelFunction"] = {}
        self._programs: Dict[torch.device, "Compiled"] = {}
        # partition threads share one model: each memoized variant must
        # be built once, or two threads would hold two programs (and two
        # coalescing queues) for the same function
        self._memo_lock = threading.Lock()

    #: what stays behind when a model is pickled (a cluster worker's op
    #: chain): the memo lock, the device programs with their captured
    #: graphs, the memoized variants, which a worker builds again, and
    #: the Trainer's step cache (``train/trainer.py``)
    _LOCAL_STATE = ("_memo_lock", "_programs", "_flat_cache",
                    "_resize_cache", "_precision_cache", "_train_step_cache")

    def __getstate__(self) -> Dict[str, Any]:
        """The model without its process-local state (:attr:`_LOCAL_STATE`):
        its apply function, weights, spec, name and flags. The cluster
        transport (``cluster/transport.py``) sends every tensor of the
        weights as a CPU array, once per pickle however many variants
        share it; the receiving process moves them to its own
        ``EngineConfig.device`` at its first forward, as here."""
        state = dict(self.__dict__)
        for key in self._LOCAL_STATE:
            state.pop(key, None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._flat_cache = None
        self._resize_cache = {}
        self._precision_cache = {}
        self._programs = {}
        self._memo_lock = threading.Lock()

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
                            input_spec or self.input_spec, name=self.name,
                            trainable_mask=self.trainable_mask)
        out.kernel_routable = self.kernel_routable
        out.compute_dtype = self.compute_dtype
        return out

    def with_postprocess(self, post: Callable[[torch.Tensor], torch.Tensor]
                         ) -> "ModelFunction":
        apply_fn = self.apply_fn

        def fn(vs, x):
            return post(apply_fn(vs, x))

        out = ModelFunction(fn, self.variables, self.input_spec,
                            name=self.name,
                            trainable_mask=self.trainable_mask)
        out.kernel_routable = self.kernel_routable
        out.compute_dtype = self.compute_dtype
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

        return ModelFunction(fn, variables, self.input_spec, name=self.name,
                             trainable_mask=self.trainable_mask)

    def with_dtype(self, precision: str) -> "ModelFunction":
        """The precision knob (``EngineConfig.inference_precision`` applies
        it at the executor). ``"float32"`` returns ``self``; ``"bfloat16"``
        is :meth:`with_compute_dtype`; ``"int8"`` is weight-only
        post-training quantization (:meth:`_quantized_int8`). Memoized
        per precision, built once across threads: the coalescing
        executor keys its queues on the variant. A variant (or a wrapper
        of one) asked for its own :attr:`compute_dtype` returns itself."""
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}")
        if precision == "float32" or precision == self.compute_dtype:
            return self
        with self._memo_lock:
            out = self._precision_cache.get(precision)
            if out is None:
                out = (self._quantized_int8() if precision == "int8"
                       else self.with_compute_dtype(precision))
                out.compute_dtype = precision
                self._precision_cache[precision] = out
        return out

    def _quantized_int8(self) -> "ModelFunction":
        """Weight-only post-training quantization, the reference's:
        symmetric per-channel int8 weights, dequantized to bf16 inside the
        forward (so inside a captured graph), bf16 activations, float32
        outputs. A module's kernels are quantized per output channel
        (:func:`_quantized_module`), a plain tree's float tensors of
        ndim ≥ 2 per their last axis (:func:`_quantize_tree`). The
        variant keeps :attr:`kernel_routable`, as the reference's does
        (unlike bf16's :meth:`with_compute_dtype`), so under
        ``"autotune"`` its sites are collected and auditioned. The
        ``trainable_mask`` is dropped with it, as the reference drops it:
        quantized weights are for inference only."""
        apply_fn = self.apply_fn
        if isinstance(self.variables, torch.nn.Module):
            variables = _quantized_module(self.variables)
        else:
            variables = _quantize_tree(self.variables)

        def fn(vs, x):
            return apply_fn(_dequantize_tree(vs),
                            x.to(torch.bfloat16)).float()

        out = ModelFunction(fn, variables, self.input_spec, name=self.name)
        out.kernel_routable = self.kernel_routable
        return out

    def weight_bytes(self) -> int:
        """Bytes of every tensor the model holds: a module's parameters
        and buffers, a plain tree's leaves (a quantized leaf counts its
        int8 payload plus its scales) — the reference's residency count."""
        if isinstance(self.variables, torch.nn.Module):
            leaves = itertools.chain(self.variables.parameters(),
                                     self.variables.buffers())
        else:
            leaves = _tree_leaves(self.variables)
        return sum(int(getattr(t, "nbytes", 0) or 0) for t in leaves)

    def device_variants(self) -> List["ModelFunction"]:
        """This model and every memoized variant reachable from it: the
        flattener, the resize wrappers and the precision variants,
        transitively. Each variant owns its own programs (captured graphs
        and their memory pool) and a precision variant its own copy of
        the weights, so an eviction must visit all of them."""
        seen: Dict[int, "ModelFunction"] = {}
        stack: List["ModelFunction"] = [self]
        while stack:
            m = stack.pop()
            if id(m) in seen:
                continue
            seen[id(m)] = m
            with m._memo_lock:
                if m._flat_cache is not None:
                    stack.append(m._flat_cache)
                stack.extend(m._precision_cache.values())
                stack.extend(m._resize_cache.values())
        return list(seen.values())

    def release_device_state(self) -> None:
        """Drop every captured graph (and with the last of them its
        memory pool) of this model and its variants, and forget the
        variants themselves: the eviction primitive behind the serving
        residency manager. The weights are untouched (their owner decides
        whether to drop its reference); the next :meth:`jitted` call
        captures again, the cold-start cost the ``sparkdl.model_load``
        span shows."""
        for m in self.device_variants():
            with m._memo_lock:
                programs = list(m._programs.values())
                m._programs = {}
            for program in programs:
                program.release()
        with self._memo_lock:
            self._flat_cache = None
            self._resize_cache.clear()
            self._precision_cache.clear()

    def flattened(self) -> "ModelFunction":
        """Outputs flattened to (batch, -1) — the ``buildFlattener`` analog.
        Memoized, so its precision variants are built once."""
        with self._memo_lock:
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
        th, tw = target
        with self._memo_lock:
            wrapped = self._resize_cache.get(key)
            if wrapped is None:
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
                # pre() consults route_preproc whatever the parent's body
                # holds
                wrapped.kernel_routable = True
                wrapped.compute_dtype = self.compute_dtype
                self._resize_cache[key] = wrapped
        return wrapped

    # -- execution -----------------------------------------------------------

    def to(self, device) -> "ModelFunction":
        """Move the weights to ``device`` (in place). A no-op when they are
        there already: the CUDA graphs captured over them read them where
        they lie, so weights that do move drop every graph captured over
        them. The check and the move are one step under
        ``kernels.weights_lock``: of two threads making the first call on
        one model, one moves it and the other finds it moved."""
        if isinstance(self.variables, torch.nn.Module):
            device = _resolved(torch.device(device))
            with kernels.weights_lock:
                tensors = itertools.chain(self.variables.parameters(),
                                          self.variables.buffers())
                if any(t.device != device for t in tensors):
                    for program in list(_PROGRAMS_OVER.get(self.variables,
                                                           ())):
                        program.drop()
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

    def jitted(self, device="cuda") -> "Compiled":
        """``(chunk, n_valid) -> output rows`` on ``device``: on the card
        one captured CUDA graph per input shape, the JAX package's one
        compiled program per bucket (:class:`Compiled`). Memoized per
        device."""
        device = _resolved(torch.device(device))
        program = self._programs.get(device)
        if program is None:
            with self._memo_lock:
                program = self._programs.get(device)
                if program is None:
                    program = self._programs[device] = Compiled(self, device)
        return program

    def apply_batch(self, array, batch_size: int = 64, device="cuda",
                    prefetch: int = 2,
                    planner: Optional[batching.BucketPlanner] = None,
                    retry_policy: Optional[resilience.RetryPolicy] = None
                    ) -> np.ndarray:
        """Run over N rows in padded chunks on ``device``; returns numpy.

        Chunks are staged ``prefetch`` ahead on a background thread into
        pinned host buffers (``core.batching.run_batched``; 0 = inline),
        each uploaded with one host-to-device copy and run by
        :meth:`jitted`: cast on the device to the spec dtype, then the
        body, as the JAX package's compiled program does. ``planner``:
        the telemetry-tuned bucket ladder (``batching.planner_for``),
        dropped when built for another batch size.

        Failures are classified per chunk (``core.resilience``, under
        ``retry_policy``): transient errors retry with backoff, a device
        OOM re-chunks at a halved bucket, fatal errors propagate. An OOM
        that still escapes re-runs the whole call at half
        ``batch_size`` (the inputs are on the host, so the re-run is
        idempotent) and drops the planner, whose ladder no longer
        matches; at a ``batch_size`` of one it propagates."""
        device = torch.device(device)
        array = self.stage_inputs(array)
        self.to(device)
        if planner is not None and planner.batch_size != batch_size:
            planner = None  # foreign ladder: fall back to pow2
        fn = self.jitted(device)
        while True:
            try:
                return batching.run_batched(fn, array, batch_size, device,
                                            prefetch=prefetch,
                                            planner=planner,
                                            retry_policy=retry_policy)
            except Exception as e:  # noqa: BLE001 - classified below
                half = batch_size // 2
                if resilience.classify(e) != resilience.OOM or half < 1:
                    raise
                logger.warning(
                    "%s: device OOM at batch_size %d (%s); re-running at %d",
                    self.name, batch_size, e, half)
                batch_size = half
                planner = None  # halved ladder: planner no longer matches

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.variables, x)

    def __repr__(self) -> str:
        return (f"ModelFunction({self.name}, input={self.input_spec.shape} "
                f"{self.input_spec.dtype})")


def _resolved(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current index>``, as a tensor's device reads."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# weights (an nn.Module) -> the programs captured over them, so weights
# that move drop every graph that reads them, whichever wrapper moved them
_PROGRAMS_OVER: "weakref.WeakKeyDictionary[torch.nn.Module, Any]" = \
    weakref.WeakKeyDictionary()
_PROGRAMS_LOCK = threading.Lock()
#: one capture stream per device: each warm-up and capture runs on it
_CAPTURE_STREAMS: Dict[int, Any] = {}


def _capture_stream(device: torch.device):
    """The stream every warm-up and capture on ``device`` runs on. A
    library's per-stream workspace (cuBLAS's and cuBLASLt's, keyed by
    handle and stream) is allocated at its first use on a stream; on this
    one that is the warm-up, outside any graph's pool, so no pool holds a
    workspace that outlives the pool's model."""
    with _PROGRAMS_LOCK:
        stream = _CAPTURE_STREAMS.get(device.index)
        if stream is None:
            stream = _CAPTURE_STREAMS[device.index] = \
                torch.cuda.Stream(device)
        return stream


def _pool_bytes(device: torch.device, pool) -> int:
    """The bytes the caching allocator holds for the graph memory pool
    ``pool`` on ``device``: the segments of that pool only, so another
    thread's allocations meanwhile are not counted."""
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("device") == device.index
               and tuple(seg.get("segment_pool_id") or ()) == want)


def _oom_in_chain(err: BaseException) -> Optional[BaseException]:
    """The allocator's out-of-memory error among ``err`` and the errors
    it was raised while handling, if any: a capture that fails to
    allocate is ended on the way out, and an error that ending raises
    must not hide the OOM the re-chunk acts on."""
    seen = 0
    while err is not None and seen < 8:
        if isinstance(err, torch.OutOfMemoryError) or \
                "out of memory" in str(err).lower():
            return err
        err = err.__cause__ or err.__context__
        seen += 1
    return None


def programs() -> List["Compiled"]:
    """Every live device program of this process (each counts its
    forwards in ``replays``): a cluster worker sums them into its
    end-of-run snapshot."""
    with _PROGRAMS_LOCK:
        return [p for progs in _PROGRAMS_OVER.values() for p in progs]


@dataclass
class _Graph:
    """One captured program: the graph, its static input and output, the
    launches of each kernel one replay makes, the tensors it reads by
    address that it did not allocate, and the bytes its capture added to
    the model's graph memory pool (a later rung reuses what an earlier
    one freed, so it adds less)."""

    graph: Any
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: Dict[str, Any]
    held: List[torch.Tensor]
    pool_bytes: int


class Compiled:
    """A :class:`ModelFunction`'s ``(chunk, n_valid) -> output rows`` on
    one device: the port of the JAX package's ``jitted``.

    On the card, the first sight of a key — the chunk's shape and dtype,
    the kernel gate's mode and its verdict generation
    (``kernels.generation``) — runs inside a ``sparkdl.compile`` span:

    1. the kernel verdicts are settled (``kernels.ensure_autotuned``, an
       abstract pass and at most one audition per new site under
       ``"autotune"``), so no audition ever runs inside a capture;
    2. one eager warm-up forward on the chunk fills every cache a forward
       fills at first use (built kernels, the float32 body's weight
       layout, the resize tables, library handles and their per-stream
       workspaces) on the stream the capture then runs on;
    3. cast → [resize] → preprocess → model → [flatten] is captured as one
       ``torch.cuda.CUDAGraph`` from a static input into a static output.

    Every chunk is then copied into the static input on the current
    stream, the graph replayed, and a device copy of the valid output
    rows returned before the next replay overwrites them. The rungs of
    one model share one graph memory pool. A graph's kernels launch
    without their wrappers, so the launch counters
    (``kernels.launches``) get the launches its capture recorded at each
    replay, and none for the capture itself; the warm-up counts as the
    launches it made. A forward that cannot be captured raises: nothing
    runs eagerly in its place. A graph captured under another mode or
    generation is dropped when its shape is captured again.

    On the CPU the same function runs eagerly, since the caller asked for
    the CPU, with the same ``sparkdl.compile`` span at each new key.
    """

    def __init__(self, model: ModelFunction, device: torch.device) -> None:
        self.model = model
        self.device = device
        self._spec_dtype = torch_dtype(model.input_spec.dtype)
        self._graphs: Dict[Tuple, _Graph] = {}
        self._seen: set = set()
        self._pool = None
        self._lock = threading.Lock()
        #: forwards run (replays on the card), first sights included
        self.replays = 0
        self.__sparkdl_trace_target__ = self._abstract
        if isinstance(model.variables, torch.nn.Module):
            with _PROGRAMS_LOCK:
                _PROGRAMS_OVER.setdefault(model.variables,
                                          weakref.WeakSet()).add(self)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self._spec_dtype))

    def _abstract(self, x: torch.Tensor) -> torch.Tensor:
        """The output of ``x`` (meta) without running or capturing."""
        return kernels.abstract_output(self._forward, x,
                                       self.model.variables)

    def _settle(self, x: torch.Tensor) -> None:
        if self.model.kernel_routable:
            kernels.ensure_autotuned(self._forward, x, model=self.model.name,
                                     variables=self.model.variables)

    def _key(self, chunk: torch.Tensor) -> Tuple:
        return (tuple(chunk.shape), chunk.dtype, kernels.kernel_mode(),
                kernels.generation())

    @property
    def graphs(self) -> Dict[Tuple, _Graph]:
        """The captured graphs by key (shape, dtype, mode, generation)."""
        return dict(self._graphs)

    def drop(self) -> None:
        """Forget every captured graph (the weights moved). Takes no lock:
        :meth:`ModelFunction.to` calls it under ``kernels.weights_lock``,
        which a capture takes after this program's lock, so taking that
        lock here would invert the order. One rebinding swaps the table;
        a replay holding a graph of the old one finishes with it."""
        self._graphs = {}

    def release(self) -> None:
        """Forget every captured graph, the shapes seen and the memory
        pool, after the replay in flight (if any) has finished; the next
        call captures again."""
        with self._lock:
            self._graphs = {}
            self._seen = set()
            self._pool = None

    def __call__(self, chunk: torch.Tensor,
                 n_valid: Optional[int] = None) -> torch.Tensor:
        n_valid = chunk.shape[0] if n_valid is None else n_valid
        key = self._key(chunk)
        if self.device.type != "cuda":
            x = chunk.to(self.device)
            with self._lock:
                first = key not in self._seen
                self._seen.add(key)
                self.replays += 1
            if not first:
                with kernels.weights_lock:
                    return self._forward(x)[:n_valid]
            with profiling.annotate(telemetry.SPAN_COMPILE,
                                    model=self.model.name,
                                    shapes=repr(key[:2])), \
                    kernels.weights_lock:
                self._settle(x)
                out = self._forward(x)
            return out[:n_valid]
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._capture(chunk, key)
            self.replays += 1
            with kernels.device_gate.shared():
                graph.static_in.copy_(chunk, non_blocking=True)
                graph.graph.replay()
                kernels.add_launches(graph.launches)
                return graph.static_out[:n_valid].clone()

    def _capture(self, chunk: torch.Tensor, key: Tuple) -> _Graph:
        """Settle, warm up and capture one key, holding
        ``kernels.device_gate`` exclusively (no other capture, audition
        or replay runs meanwhile) and ``kernels.weights_lock`` (no other
        thread swaps the weights for meta tensors meanwhile). The graph's
        launches are those its own thread's wrappers recorded
        (``kernels.recording_launches``) and its pool bytes those its own
        pool grew by. A capture that fails (an allocation that does not
        fit) stores nothing: the capture is ended, its tensors released,
        and an out-of-memory error reaches the caller as such."""
        with profiling.annotate(telemetry.SPAN_COMPILE,
                                model=self.model.name,
                                shapes=repr(key[:2])), \
                kernels.device_gate.exclusive(), kernels.weights_lock:
            static_in = torch.empty(chunk.shape, dtype=chunk.dtype,
                                    device=self.device)
            static_in.copy_(chunk, non_blocking=True)
            self._settle(static_in)
            current = torch.cuda.current_stream(self.device)
            stream = _capture_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self._forward(static_in)
            current.wait_stream(stream)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()  # as the capture does, before counting
            reserved = _pool_bytes(self.device, self._pool)
            try:
                with kernels.recording_launches() as launches, \
                        kernels.holding_references() as held, \
                        torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                         capture_error_mode="thread_local"):
                    static_out = self._forward(static_in)
            except BaseException as err:
                del graph
                oom = _oom_in_chain(err)
                if oom is not None and oom is not err:
                    raise oom from None
                raise
            pool_bytes = _pool_bytes(self.device, self._pool) - reserved
            stale = [k for k in self._graphs if k[:2] == key[:2]]
            for k in stale:
                del self._graphs[k]
            out = self._graphs[key] = _Graph(graph, static_in, static_out,
                                             launches, held, pool_bytes)
        return out
