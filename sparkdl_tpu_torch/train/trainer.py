"""Trainer — the training engine on one card.

A port of ``sparkdl_tpu.train.trainer``. The reference jits one XLA
program per step (forward, backward, optimizer update, model-state
update, with the state donated). Here the step runs eagerly on
``EngineConfig.device``: the forward through ``torch.func.functional_call``
over the state's params and buffers, a float32 loss, ``autograd.grad``
for the trainable params, and the optimizer's in-place update
(``train/optimizers.py``). BatchNorm layers in train mode update their
running statistics in place in the state's model state.

The pipelined loop (:meth:`Trainer.fit`) is the reference's: staging on a
``DevicePrefetcher`` thread, the step counter tracked on the host, the
device awaited only at the sync points, exact resume from the latest
checkpoint. A mesh (data parallel over several cards) is not ported yet.
"""

from __future__ import annotations

import inspect
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.core import (
    debug, health, kernels, pipeline, profiling, resilience, telemetry,
)
from sparkdl_tpu_torch.train.checkpoint import CheckpointManager
from sparkdl_tpu_torch.train.metrics import MetricsLogger
from sparkdl_tpu_torch.train.optimizers import (
    Optimizer, accuracy_metric, make_loss, make_optimizer,
)

_NO_MESH = ("data-parallel training over a mesh of cards is not ported "
            "yet (ROADMAP Queue 1 item 5: distributed); pass mesh=None")


@dataclass
class TrainState:
    """Full training state — everything checkpoint/resume needs.

    ``step``: an int64 scalar on the device; ``params``: name → tensor
    (float32 masters); ``opt_state``: the optimizer's state;
    ``model_state``: name → buffer (BatchNorm running statistics, float32
    always; {} when stateless); ``rng``: the generator a model may draw
    from (dropout), in place of the reference's PRNG key. The step
    updates every tensor in place."""

    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    model_state: Dict[str, torch.Tensor]
    rng: torch.Generator


def _resolve_device(device) -> torch.device:
    if device is None:
        from sparkdl_tpu_torch.core.executor import resolve_device

        return resolve_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"training device {device} asked for but CUDA is not "
            "available; pass device='cpu' (or set EngineConfig.device) to "
            "train on the CPU")
    return device


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A plain tree (dicts, lists, tuples) as {dotted path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten(template: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """``template``'s structure with each leaf taken from ``flat``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, flat, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat.get(prefix, template)


def _takes_generator(fn: Callable) -> bool:
    try:
        return "generator" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@dataclass
class Trainer:
    """Builds and runs the train step for one model.

    ``apply_fn(params, model_state, x, train, generator) -> out``, params
    and model state as name → tensor dicts. Use the constructors
    ``from_module`` / ``from_model_function`` instead of filling this in
    by hand.
    """

    apply_fn: Callable
    loss: Callable
    optimizer: Optimizer
    device: torch.device
    mesh: Any = None
    has_model_state: bool = False
    compute_accuracy: bool = True
    accuracy_from_logits: bool = False
    # Mixed precision (keras mixed_precision parity): forward and backward
    # in this dtype (bf16 keeps float32's exponent range, so no loss
    # scaling), float32 master params, optimizer state and update, and a
    # float32 model state. None = full precision.
    compute_dtype: Any = None
    # Optional shared step cache (from_model_function wires it to the
    # ModelFunction): repeated fits of one model reuse one step object.
    # Safe because the step closes over no fit-specific value: params and
    # optimizer state arrive in the TrainState, the learning rate in it.
    step_cache: Any = None
    step_cache_key: Any = None
    # the trained weights of a state, as variables_of returns them (None:
    # the params and model state as one state dict)
    variables_fn: Optional[Callable[["TrainState"], Any]] = None

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_module(cls, module: torch.nn.Module,
                    loss="categorical_crossentropy", optimizer="adam",
                    learning_rate: Optional[float] = None, mesh=None,
                    from_logits: bool = False, device=None,
                    **kwargs) -> Tuple["Trainer", TrainState]:
        """``nn.Module`` (its own parameters and buffers as the starting
        point) → (trainer, initial state): the ``from_flax`` counterpart.

        The step runs the module in train mode, so BatchNorm layers use
        batch statistics and update their running statistics (the
        model state) in the same step; eval and ``evaluate`` run it in
        eval mode. A module whose ``forward`` takes ``generator`` gets
        the state's generator."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        device = _resolve_device(device)
        module.to(device)
        params = {n: p.detach() for n, p in module.named_parameters()}
        model_state = {n: b.detach() for n, b in module.named_buffers()}
        pass_gen = _takes_generator(module.forward)

        def apply_fn(ps, ms, x, train, generator):
            module.train(train)
            kw = {"generator": generator} if pass_gen else {}
            return torch.func.functional_call(module, {**ps, **ms}, (x,), kw)

        trainer = cls(apply_fn=apply_fn,
                      loss=make_loss(loss, from_logits=from_logits),
                      optimizer=make_optimizer(optimizer, learning_rate),
                      device=device, has_model_state=bool(model_state),
                      accuracy_from_logits=from_logits,
                      variables_fn=lambda st: {**st.params,
                                               **st.model_state},
                      **kwargs)
        return trainer, trainer.init_state(params, model_state)

    @classmethod
    def from_model_function(cls, mf, loss="categorical_crossentropy",
                            optimizer="adam",
                            learning_rate: Optional[float] = None, mesh=None,
                            from_logits: bool = False, device=None,
                            **kwargs) -> Tuple["Trainer", TrainState]:
        """ModelFunction → (trainer, state).

        The model runs in its inference form (normalization uses stored
        moving statistics — fine-tune semantics), through ``mf.apply_fn``
        eagerly with grad on, never its captured inference graphs.
        Weights its ``trainable_mask`` marks False are frozen: they get
        no gradient and no update."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        device = _resolve_device(device)
        variables = mf.variables
        if isinstance(variables, torch.nn.Module):
            mf.to(device)  # drops any graph captured over the old place
            params = {n: p.detach()
                      for n, p in variables.named_parameters()}
            mask = dict(mf.trainable_mask or {})
            wrapped = kernels._Calls(lambda x: mf.apply_fn(variables, x),
                                     variables)

            def apply_fn(ps, ms, x, train, generator):
                # the swap of the module's weights for the state's is
                # seen by no other thread's forward of the same model
                with kernels.weights_lock:
                    return torch.func.functional_call(
                        wrapped,
                        {f"variables.{n}": p for n, p in ps.items()}, (x,))

            def variables_fn(st):
                return dict(st.params)
        else:
            flat = {k: torch.as_tensor(v)
                    for k, v in _flatten(variables).items()}
            params = {k: v.to(device) for k, v in flat.items()
                      if v.is_floating_point()}
            mask = _flatten(mf.trainable_mask) \
                if mf.trainable_mask is not None else {}

            def apply_fn(ps, ms, x, train, generator):
                return mf.apply_fn(_unflatten(variables, ps), x)

            def variables_fn(st):
                return _unflatten(variables, st.params)

        unknown = set(mask) - set(params)
        if unknown:
            raise ValueError(
                f"trainable_mask names {sorted(unknown)[:5]} that are not "
                f"weights of model {mf.name!r}")
        tx = make_optimizer(optimizer, learning_rate)
        frozen = {n for n, t in mask.items() if not t}
        if frozen:
            tx = tx.with_trainable([n for n in params if n not in frozen])
        cache = cache_key = None
        if isinstance(loss, str) and isinstance(optimizer, str):
            # the learning rate is NOT part of the key (it lives in the
            # optimizer state); every other option is, and an unhashable
            # one disables caching rather than risking a stale step
            try:
                cache_key = (loss, optimizer, from_logits, mesh, str(device),
                             tuple(sorted(
                                 (k, str(v)) for k, v in kwargs.items())))
                hash(cache_key)
            except TypeError:
                cache_key = None
            if cache_key is not None:
                cache = mf.__dict__.setdefault("_train_step_cache", {})
        trainer = cls(apply_fn=apply_fn,
                      loss=make_loss(loss, from_logits=from_logits),
                      optimizer=tx, device=device, has_model_state=False,
                      accuracy_from_logits=from_logits,
                      step_cache=cache, step_cache_key=cache_key,
                      variables_fn=variables_fn, **kwargs)
        return trainer, trainer.init_state(params, {})

    # -- state ---------------------------------------------------------------

    def _trainable(self, params: Dict[str, torch.Tensor]) -> List[str]:
        names = self.optimizer.trainable
        return [n for n, p in params.items() if p.is_floating_point()
                and (names is None or n in names)]

    def _ready(self, state: TrainState) -> TrainState:
        """Mark the trainable params as autograd leaves."""
        for n in self._trainable(state.params):
            state.params[n].requires_grad_(True)
        return state

    def init_state(self, params: Dict[str, torch.Tensor],
                   model_state: Optional[Dict[str, torch.Tensor]] = None,
                   seed: int = 0) -> TrainState:
        """Fresh copies on the trainer's device: the step updates them in
        place, so the caller's tensors (e.g. two trainers started from one
        module) are never touched. Float model state is float32."""
        params = {n: p.detach().to(self.device, copy=True)
                  for n, p in params.items()}
        model_state = {
            n: (b.detach().to(self.device, torch.float32, copy=True)
                if b.is_floating_point()
                else b.detach().to(self.device, copy=True))
            for n, b in (model_state or {}).items()}
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        state = TrainState(
            step=torch.zeros((), dtype=torch.int64, device=self.device),
            params=params, opt_state=self.optimizer.init(params),
            model_state=model_state, rng=rng)
        return self._ready(state)

    # -- the step ------------------------------------------------------------

    def make_train_step(self) -> Callable:
        """``(state, x, y) -> (state, metrics)``: forward, float32 loss,
        backward, update, model-state update — in place, no host sync.
        With a shared ``step_cache`` (from_model_function) the step is
        built once per key and reused by every later fit of the model."""
        if self.step_cache is not None:
            cached = self.step_cache.get((self.step_cache_key, "train"))
            if cached is not None:
                return cached
        loss_fn = self.loss
        apply_fn = self.apply_fn
        optimizer = self.optimizer
        want_acc = self.compute_accuracy
        acc_from_logits = self.accuracy_from_logits
        compute_dtype = self.compute_dtype
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        trainable_of = self._trainable

        def to_compute(t: torch.Tensor) -> torch.Tensor:
            if compute_dtype is not None and t.is_floating_point():
                return t.to(compute_dtype)
            return t

        def step_fn(state: TrainState, x, y):
            names = trainable_of(state.params)
            with torch.enable_grad():
                # the model state (BN running statistics) stays float32
                # under mixed precision: the moving-average update's small
                # increments would underflow bf16's 8-bit mantissa
                params = {n: to_compute(p) for n, p in state.params.items()}
                out = apply_fn(params, state.model_state, to_compute(x),
                               True, state.rng)
                # the loss in float32 whatever the compute dtype
                loss = loss_fn(out.float(), y)
                grads = torch.autograd.grad(
                    loss, [state.params[n] for n in names],
                    allow_unused=True)
            # the casts are in the graph, so the grads land on the float32
            # masters already
            optimizer.apply(state.params, dict(zip(names, grads)),
                            state.opt_state)
            state.step.add_(1)
            metrics = {"loss": loss.detach()}
            if want_acc and out.dim() >= 2:
                with torch.no_grad():
                    metrics["accuracy"] = accuracy_metric(
                        out.detach(), y, from_logits=acc_from_logits)
            return state, metrics

        if self.step_cache is not None:
            self.step_cache[(self.step_cache_key, "train")] = step_fn
        return step_fn

    def make_eval_step(self) -> Callable:
        """``(state, x) -> out``, the model in eval mode, no grad."""
        apply_fn = self.apply_fn

        def eval_fn(state: TrainState, x):
            with torch.no_grad():
                return apply_fn(state.params, state.model_state, x, False,
                                None)

        return eval_fn

    def make_eval_metrics_step(self) -> Callable:
        """``(state, x, y) -> {loss, accuracy}`` (no grads)."""
        if self.step_cache is not None:
            cached = self.step_cache.get((self.step_cache_key, "eval"))
            if cached is not None:
                return cached
        own = self.__dict__.get("_eval_step")
        if own is not None:
            return own
        apply_fn = self.apply_fn
        loss_fn = self.loss
        want_acc = self.compute_accuracy
        acc_from_logits = self.accuracy_from_logits

        def eval_fn(state: TrainState, x, y):
            with torch.no_grad():
                out = apply_fn(state.params, state.model_state, x, False,
                               None)
                metrics = {"loss": loss_fn(out, y)}
                if want_acc:
                    metrics["accuracy"] = accuracy_metric(
                        out, y, from_logits=acc_from_logits)
            return metrics

        if self.step_cache is not None:
            self.step_cache[(self.step_cache_key, "eval")] = eval_fn
        else:
            self.__dict__["_eval_step"] = eval_fn
        return eval_fn

    def _to_device(self, arr) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(arr)).to(self.device)
        return t.float() if t.dtype == torch.uint8 else t

    def evaluate(self, state: TrainState,
                 batches: Iterable[Tuple[np.ndarray, np.ndarray]]
                 ) -> Dict[str, float]:
        """Mean loss/accuracy over a batch stream (keras ``evaluate``),
        weighted by batch size."""
        eval_step = self.make_eval_metrics_step()
        totals: Dict[str, float] = {}
        n = 0
        for x, y in batches:
            m = eval_step(state, self._to_device(x), self._to_device(y))
            k = len(x)
            n += k
            for key, value in m.items():
                totals[key] = totals.get(key, 0.0) + float(value) * k
        if n == 0:
            return {}
        return {f"val_{k}": v / n for k, v in totals.items()}

    # -- the loop ------------------------------------------------------------

    def fit(self, state: TrainState,
            batches: Iterable[Tuple[np.ndarray, np.ndarray]],
            epochs: int = 1,
            metrics_logger: Optional[MetricsLogger] = None,
            checkpoint: Optional[CheckpointManager] = None,
            checkpoint_every: int = 0,
            resume: bool = True,
            on_step: Optional[Callable[[int], None]] = None,
            on_epoch: Optional[Callable[[int, TrainState], None]] = None,
            sync_every: int = 8,
            prefetch: int = 2) -> TrainState:
        """Run the pipelined train loop; resume from the latest checkpoint.

        ``batches``: a reiterable of ``(x, y)`` numpy pairs. Host pull and
        staging of batch ``k+1`` run on a ``DevicePrefetcher`` thread
        (``prefetch`` deep; 0 = inline) while the card trains batch ``k``;
        uint8 batches upload raw and cast to float32 on the device. The
        step counter is tracked on the HOST and the device is awaited
        only at the sync points: every ``sync_every`` steps, checkpoint
        writes, before each ``on_step`` call and at epoch ends. Metrics
        defer on the device and materialize at sync points. Exact resume
        replays the batch stream and skips the first ``state.step``
        positions without staging them. ``on_step(step)`` is the fault
        hook: raising from it aborts the loop as a worker loss would.
        ``on_epoch(epoch_index, state)`` fires after each epoch.

        After the fit, :attr:`fit_stats` holds its steps, sync points,
        checkpoint saves and seconds.
        """
        if self.mesh is not None:
            raise NotImplementedError(_NO_MESH)
        if checkpoint is not None and resume:
            latest = checkpoint.latest_step()
            if latest is not None:
                state = self._ready(checkpoint.restore(state))
                health.record(health.FIT_RESUMED, step=int(state.step))
        train_step = self.make_train_step()
        device = self.device
        pin = device.type == "cuda"
        stats = {"steps": 0, "syncs": 0, "checkpoint_saves": 0,
                 "checkpoint_save_s": [], "seconds": 0.0}
        self.fit_stats = stats
        t_fit = time.perf_counter()

        def stage_pair(pair):
            """Staging thread: host (x, y) → (n, x, y) CPU tensors, pinned
            for an asynchronous upload on the card."""
            x, y = pair
            with profiling.annotate(profiling.STAGE_BATCH):
                xh = torch.from_numpy(np.ascontiguousarray(x))
                yh = torch.from_numpy(np.ascontiguousarray(y))
                if pin:
                    xh, yh = xh.pin_memory(), yh.pin_memory()
                return len(x), xh, yh

        def upload(t: torch.Tensor) -> torch.Tensor:
            t = t.to(device, non_blocking=True)
            return t.float() if t.dtype == torch.uint8 else t

        done = int(state.step)
        host_step = done
        global_idx = 0
        sync_every = max(1, int(sync_every))
        last_sync_t: Optional[float] = None
        last_sync_step = done

        def sync(st: TrainState) -> None:
            """The ONLY place the step loop waits for the device: drains
            the deferred metrics (one batched fetch), then reads the
            device step counter and holds it to the host's."""
            nonlocal last_sync_t, last_sync_step
            stats["syncs"] += 1
            if metrics_logger is not None:
                metrics_logger.flush()
            with profiling.annotate(profiling.DEVICE_SYNC):
                device_step = int(st.step)
            if device_step != host_step:
                raise RuntimeError(
                    f"pipelined fit desynchronized: device step "
                    f"{device_step} != host-tracked step {host_step} — "
                    "the batch stream or state chain was tampered with "
                    "mid-fit")
            now = time.perf_counter()
            if last_sync_t is not None and host_step > last_sync_step:
                dt = now - last_sync_t
                if dt > 0:
                    telemetry.observe(telemetry.M_STEPS_PER_SEC,
                                      (host_step - last_sync_step) / dt)
            last_sync_t, last_sync_step = now, host_step

        def save_checkpoint(st: TrainState) -> None:
            t0 = time.perf_counter()
            with telemetry.span(telemetry.SPAN_CHECKPOINT_SAVE,
                                step=host_step):
                checkpoint.save(host_step, st)
            stats["checkpoint_saves"] += 1
            stats["checkpoint_save_s"].append(time.perf_counter() - t0)

        def epoch_source():
            # the staging thread: resume-skipped positions are counted
            # but never staged
            nonlocal global_idx
            for pair in batches:
                if global_idx < done:
                    global_idx += 1
                    continue
                global_idx += 1
                yield pair

        fit_span = telemetry.span(telemetry.SPAN_FIT, epochs=epochs,
                                  resume_step=done, prefetch=prefetch,
                                  sync_every=sync_every)
        last_dispatch = None
        scope = debug.maybe_debug_mode()
        try:
            fit_span.__enter__()
            scope.__enter__()
            for _epoch in range(epochs):
                with telemetry.span(telemetry.SPAN_EPOCH, epoch=_epoch), \
                        pipeline.DevicePrefetcher(
                        epoch_source(), stage_fn=stage_pair,
                        depth=prefetch, name="trainer.fit",
                        report_health=True) as staged:
                    for n_examples, xh, yh in staged:
                        # dispatch only: the card's work is awaited at
                        # the sync points
                        with profiling.annotate("sparkdl.train_step",
                                                step=host_step + 1):
                            state, metrics = train_step(state, upload(xh),
                                                        upload(yh))
                        host_step += 1
                        now = time.perf_counter()
                        if last_dispatch is not None:
                            telemetry.observe(telemetry.M_STEP_TIME_S,
                                              now - last_dispatch)
                        last_dispatch = now
                        if metrics_logger is not None:
                            metrics_logger.log_step(host_step, metrics,
                                                    examples=n_examples,
                                                    defer=True)
                        due_ckpt = (checkpoint is not None and
                                    checkpoint_every and
                                    host_step % checkpoint_every == 0)
                        if (due_ckpt or on_step is not None
                                or host_step % sync_every == 0):
                            sync(state)
                        if due_ckpt:
                            save_checkpoint(state)
                        if on_step is not None:
                            on_step(host_step)
                        # after the checkpoint write: a preemption here
                        # loses the run between steps, and the resumed
                        # fit replays from the step just saved
                        resilience.inject("preemption", step=host_step)
                # an epoch's end is a sync point: on_epoch observes a
                # finished state and complete metrics
                sync(state)
                if on_epoch is not None:
                    on_epoch(_epoch, state)
        except BaseException:
            # flush what can be flushed before unwinding: the deferred
            # metrics (best effort) and the asynchronous checkpoint
            # writes, so a restart sees every step this attempt saved
            if metrics_logger is not None:
                try:
                    metrics_logger.flush()
                except Exception:  # noqa: BLE001 - already unwinding
                    pass
            if checkpoint is not None:
                try:
                    checkpoint.wait_until_finished()
                except Exception:  # noqa: BLE001 - already unwinding
                    pass
            stats["steps"] = host_step - done
            stats["seconds"] = time.perf_counter() - t_fit
            scope.__exit__(*sys.exc_info())
            fit_span.__exit__(*sys.exc_info())
            raise
        try:
            if checkpoint is not None:
                checkpoint.save(host_step, state, synchronous=True)
            health.record(health.FIT_COMPLETED, steps=host_step)
            fit_span.set_attribute("steps", host_step)
        except BaseException:
            scope.__exit__(*sys.exc_info())
            fit_span.__exit__(*sys.exc_info())
            raise
        stats["steps"] = host_step - done
        stats["seconds"] = time.perf_counter() - t_fit
        scope.__exit__(None, None, None)
        fit_span.__exit__(None, None, None)
        return state

    def variables_of(self, state: TrainState) -> Any:
        """The trained weights for inference: a module's state dict
        (params and buffers, for ``load_state_dict``), or the trained
        tree of a plain ``ModelFunction``'s variables."""
        detached = TrainState(
            step=state.step,
            params={n: p.detach() for n, p in state.params.items()},
            opt_state=state.opt_state,
            model_state={n: b.detach()
                         for n, b in state.model_state.items()},
            rng=state.rng)
        if self.variables_fn is None:
            return {**detached.params, **detached.model_state}
        return self.variables_fn(detached)
