"""The port's Trainer and its pipelined fit, on the CPU.

Counterparts of the JAX package's ``tests/train/test_trainer.py`` (its
mesh test aside: a mesh raises ``NotImplementedError`` here) and
``tests/train/test_pipeline_fit.py``: loss descent, running statistics,
exact resume, ModelFunction training with a frozen mask, the losses'
validation, mixed precision, the step cache; the pipelined fit bit for
bit against a serial loop, staging overlap, error propagation, deferred
metrics, preemption. Plus what the port adds: the default device
(``"cuda"``) raises without a card, the generator is restored exactly,
``debug_mode`` raises at the first NaN.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from sparkdl_tpu_torch.core import health
from sparkdl_tpu_torch.core.debug import debug_mode
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.core.resilience import (
    Fault, FaultInjector, InjectedFault,
)
from sparkdl_tpu_torch.models.layers import BatchNorm
from sparkdl_tpu_torch.train import (
    CheckpointManager, MetricsLogger, Trainer, make_loss,
)
from sparkdl_tpu_torch.train.optimizers import accuracy_metric


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "device", "cpu")


class TinyMLP(nn.Module):
    def __init__(self, d=6, classes=3, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.fc1 = nn.Linear(d, 16)
        self.fc2 = nn.Linear(16, classes)

    def forward(self, x):
        return torch.softmax(self.fc2(torch.relu(self.fc1(x))), dim=-1)


class TinyBN(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc1 = nn.Linear(6, 8)
        self.bn = BatchNorm(8)
        self.fc2 = nn.Linear(8, 2)

    def forward(self, x):
        return torch.softmax(self.fc2(self.bn(self.fc1(x))), dim=-1)


class DropoutMLP(TinyMLP):
    """Draws from the state's generator (dropout with an explicit
    generator, which ``F.dropout`` does not take)."""

    def forward(self, x, generator=None):
        h = torch.relu(self.fc1(x))
        if self.training:
            keep = torch.rand(h.shape, generator=generator) >= 0.5
            h = h * keep / 0.5
        return torch.softmax(self.fc2(h), dim=-1)


def _toy_data(n=64, d=6, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    y = np.argmax(x @ w, axis=1)
    return x, y, np.eye(classes, dtype=np.float32)[y]


def _batches(x, y, bs):
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x) - bs + 1, bs)]


def _make(cls=TinyMLP, lr=0.1, optimizer="sgd"):
    x, _, y = _toy_data()
    trainer, state = Trainer.from_module(cls(), optimizer=optimizer,
                                         learning_rate=lr)
    return trainer, state, _batches(x, y, 16)


def _leaves(state):
    return [t.detach().clone() for t in state.params.values()]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -- test_trainer.py counterparts --------------------------------------------

def test_loss_descends():
    trainer, state, batches = _make(lr=0.5)
    logger = MetricsLogger(sinks=[lambda r: None])
    state = trainer.fit(state, batches, epochs=10, metrics_logger=logger)
    losses = [r["loss"] for r in logger.history]
    assert losses[-1] < losses[0] * 0.7
    assert int(state.step) == 4 * 10


def test_batch_stats_update():
    x, _, _ = _toy_data(classes=2)
    y = np.eye(2, dtype=np.float32)[np.zeros(len(x), dtype=int)]
    module = TinyBN()
    before = {n: b.clone() for n, b in module.named_buffers()}
    trainer, state = Trainer.from_module(module)
    assert trainer.has_model_state
    state = trainer.fit(state, _batches(x, y, 16), epochs=1)
    assert all(b.dtype == torch.float32 for b in state.model_state.values())
    assert any(not torch.allclose(state.model_state[n], b)
               for n, b in before.items())
    # the caller's module keeps its own buffers: the state owns copies
    assert all(torch.equal(b, before[n]) for n, b in module.named_buffers())


def test_mesh_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        Trainer.from_module(TinyMLP(), mesh=object())
    mf = ModelFunction.fromModule(TinyMLP(), TensorSpec((None, 6)))
    with pytest.raises(NotImplementedError, match="distributed"):
        Trainer.from_model_function(mf, mesh=object())


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "device", "cuda")
    if torch.cuda.is_available():
        _, state = Trainer.from_module(TinyMLP())
        assert state.step.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not"):
            Trainer.from_module(TinyMLP())
        with pytest.raises(RuntimeError, match="CUDA is not"):
            Trainer.from_module(TinyMLP(), device="cuda")


def test_checkpoint_resume_exact(tmp_path):
    """Interrupted training resumed from its checkpoint lands on exactly
    the params of uninterrupted training."""
    trainer, ref_state, batches = _make()
    ref_state = trainer.fit(ref_state, batches, epochs=2)
    trainer2, state2, _ = _make()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))

    class Boom(RuntimeError):
        pass

    def bomb(step):
        if step == 5:
            raise Boom()

    with pytest.raises(Boom):
        trainer2.fit(state2, batches, epochs=2, checkpoint=ckpt,
                     checkpoint_every=1, on_step=bomb)
    ckpt.wait_until_finished()
    assert ckpt.latest_step() == 5
    _, fresh, _ = _make()
    with HealthMonitor() as mon:
        resumed = trainer2.fit(fresh, batches, epochs=2, checkpoint=ckpt)
    assert mon.count(health.FIT_RESUMED) == 1
    assert int(resumed.step) == 8
    assert _equal(_leaves(ref_state), _leaves(resumed))
    ckpt.close()


def test_model_function_training():
    """A plain-tree ModelFunction (the stateless path) trains."""
    x, _, y1h = _toy_data()
    mf = ModelFunction.fromFunction(
        lambda vs, x: torch.softmax(x @ vs["w"], dim=-1),
        {"w": torch.zeros(6, 3)}, TensorSpec((None, 6)))
    trainer, state = Trainer.from_model_function(mf, optimizer="sgd",
                                                 learning_rate=1.0)
    logger = MetricsLogger(sinks=[lambda r: None])
    state = trainer.fit(state, _batches(x, y1h, 32), epochs=20,
                        metrics_logger=logger)
    assert logger.history[-1]["accuracy"] > 0.8
    assert set(trainer.variables_of(state)) == {"w"}
    assert float(mf.variables["w"].abs().sum()) == 0.0  # caller's copy


def test_model_function_of_a_module_freezes_its_mask(monkeypatch):
    """A module ModelFunction runs in inference form (BatchNorm on its
    running statistics, which never move) with its mask frozen; the
    mask rides the variants, and under ``"force"`` its fused units
    raise (no backward) rather than drop the gradient."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig
    from sparkdl_tpu_torch.models.layers import SeparableConvBN

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(1)
            self.sep = SeparableConvBN(3, 4, kernel_family="net")
            # the port's layers start uninitialized (the registry inits)
            for conv in (self.sep.depthwise, self.sep.pointwise):
                nn.init.normal_(conv.weight, std=0.3)
            self.head = nn.Linear(4, 2)

        def forward(self, x):
            return torch.softmax(self.head(self.sep(x).mean((1, 2))), -1)

    mf = ModelFunction.fromModule(Net(), TensorSpec((None, 5, 5, 3)))
    mask = {n: not n.startswith("sep.depthwise")
            for n, _ in mf.variables.named_parameters()}
    mf = ModelFunction(mf.apply_fn, mf.variables, mf.input_spec,
                       name="net", trainable_mask=mask)
    assert mf.with_postprocess(lambda y: y).trainable_mask is mask
    assert mf.with_compute_dtype("bfloat16").trainable_mask is mask
    assert mf.with_dtype("int8").trainable_mask is None
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5, 5, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    trainer, state = Trainer.from_model_function(mf, optimizer="adam",
                                                 learning_rate=0.01)
    dw0 = state.params["sep.depthwise.weight"].clone()
    head0 = state.params["head.weight"].clone()
    stats0 = mf.variables.sep.bn.running_mean.clone()
    state = trainer.fit(state, [(x, y)] * 3, epochs=1)
    assert torch.equal(state.params["sep.depthwise.weight"], dw0)
    assert not torch.equal(state.params["head.weight"], head0)
    assert torch.equal(mf.variables.sep.bn.running_mean, stats0)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    trainer2, state2 = Trainer.from_model_function(mf, optimizer="sgd")
    with pytest.raises(ValueError, match="sep2d.*no backward"):
        trainer2.fit(state2, [(x, y)], epochs=1)


def test_make_optimizer_and_loss_validation():
    logits = torch.tensor([[2.0, -1.0]])
    labels = torch.tensor([[1.0, 0.0]])
    l_probs = make_loss("categorical_crossentropy")(
        torch.softmax(logits, -1), labels)
    l_logits = make_loss("categorical_crossentropy", from_logits=True)(
        logits, labels)
    np.testing.assert_allclose(float(l_probs), float(l_logits), rtol=1e-5)


def test_binary_crossentropy_rank_alignment():
    probs = torch.tensor([[0.9], [0.2], [0.8], [0.7]])
    labels = torch.tensor([1.0, 0.0, 1.0, 1.0])
    loss = make_loss("binary_crossentropy")(probs, labels)
    want = -np.mean([np.log(0.9), np.log(0.8), np.log(0.8), np.log(0.7)])
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    loss_l = make_loss("binary_crossentropy", from_logits=True)(
        torch.log(probs / (1 - probs)), labels)
    np.testing.assert_allclose(float(loss_l), want, rtol=1e-5)


def test_accuracy_metric_binary_head():
    probs = torch.tensor([[0.9], [0.2], [0.8], [0.4]])
    labels = torch.tensor([1.0, 0.0, 0.0, 1.0])
    assert float(accuracy_metric(probs, labels)) == 0.5
    assert float(accuracy_metric(probs, labels[:, None])) == 0.5


def test_binary_head_training_learns():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)

    class BinaryHead(nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.fc = nn.Linear(4, 1)

        def forward(self, x):
            return torch.sigmoid(self.fc(x))

    trainer, state = Trainer.from_module(
        BinaryHead(), loss="binary_crossentropy", optimizer="sgd",
        learning_rate=1.0)
    logger = MetricsLogger(sinks=[lambda r: None])
    trainer.fit(state, _batches(x, y, 32), epochs=15, metrics_logger=logger)
    assert logger.history[-1]["loss"] < logger.history[0]["loss"] * 0.5
    assert logger.history[-1]["accuracy"] > 0.9


def test_mixed_precision_trains_close_to_full_precision():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    labels = (x @ rng.normal(size=(8,)).astype(np.float32) > 0).astype(int)
    y = np.eye(2, dtype=np.float32)[labels]

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.fc = nn.Linear(8, 2)

        def forward(self, x):
            return torch.softmax(self.fc(x), -1)

    trainer, state = Trainer.from_module(
        Net(), optimizer="sgd", learning_rate=0.5,
        compute_dtype=torch.bfloat16)
    state = trainer.fit(state, [(x, y)] * 30, epochs=1)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(t.dtype == torch.float32
               for t in state.opt_state["learning_rate"].reshape(1))
    preds = trainer.make_eval_step()(state, torch.from_numpy(x)).argmax(-1)
    assert (preds.numpy() == labels).mean() >= 0.9


def test_mixed_precision_batch_stats_stay_f32():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=16)]
    module = TinyBN()
    init = {n: b.clone() for n, b in module.named_buffers()}
    trainer, state = Trainer.from_module(
        module, optimizer="sgd", learning_rate=0.1, compute_dtype="bfloat16")
    state = trainer.fit(state, [(x, y)], epochs=2)
    for b in state.model_state.values():
        assert b.dtype == torch.float32
    # the moving averages MOVE: bf16 statistics would stall
    assert any(not torch.allclose(state.model_state[n], b)
               for n, b in init.items())


def test_step_cache_shared_across_fits_and_lrs():
    """from_model_function fits share ONE step per (loss, optimizer, ...)
    and the learning rate lives in the state, so each fit still applies
    its own."""
    torch.manual_seed(0)
    lin = nn.Linear(4, 1)
    mf = ModelFunction.fromModule(lin, TensorSpec((None, 4)), name="lin")
    w0 = lin.weight.detach().clone()
    x = np.ones((8, 4), np.float32)
    y = np.zeros((8, 1), np.float32)

    def fitted(lr):
        trainer, state = Trainer.from_model_function(
            mf, loss="mse", optimizer="sgd", learning_rate=lr)
        state = trainer.fit(state, [(x, y)], epochs=1)
        return state.params["weight"].detach()

    p_small = fitted(1e-4)
    cache = mf._train_step_cache
    assert len(cache) == 1
    p_large = fitted(0.5)
    assert len(cache) == 1
    small = float((w0 - p_small).abs().max())
    large = float((w0 - p_large).abs().max())
    assert large > 100 * small
    assert "_train_step_cache" not in mf.__getstate__()


# -- test_pipeline_fit.py counterparts ---------------------------------------

def test_pipelined_fit_bit_identical_to_serial_loop():
    trainer, state_p, batches = _make()
    fitted = trainer.fit(state_p, batches, epochs=3, sync_every=3,
                         prefetch=2)
    _, state_s, _ = _make()
    step = trainer.make_train_step()
    for _ in range(3):
        for x, y in batches:
            state_s, _ = step(state_s, torch.from_numpy(x),
                              torch.from_numpy(y))
            _ = int(state_s.step)
    assert int(fitted.step) == int(state_s.step) == 12
    assert _equal(_leaves(fitted), _leaves(state_s))


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_pipelined_fit_matches_serial_fit_settings(optimizer):
    trainer, s1, batches = _make(optimizer=optimizer, lr=0.01)
    f1 = trainer.fit(s1, batches, epochs=2, sync_every=1, prefetch=0)
    _, s2, _ = _make(optimizer=optimizer, lr=0.01)
    f2 = trainer.fit(s2, batches, epochs=2, sync_every=7, prefetch=3)
    assert _equal(_leaves(f1), _leaves(f2))
    for k in f1.opt_state:
        if isinstance(f1.opt_state[k], dict):
            assert _equal(f1.opt_state[k].values(),
                          f2.opt_state[k].values())


def test_exact_resume_under_deferred_sync(tmp_path):
    trainer, ref_state, batches = _make()
    ref = trainer.fit(ref_state, batches, epochs=2, sync_every=3,
                      prefetch=2)
    _, s_a, _ = _make()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    partial = trainer.fit(s_a, batches, epochs=1, checkpoint=ckpt,
                          checkpoint_every=3, sync_every=3, prefetch=2)
    assert int(partial.step) == 4
    assert ckpt.latest_step() == 4
    _, s_b, _ = _make()
    resumed = trainer.fit(s_b, batches, epochs=2, checkpoint=ckpt,
                          sync_every=3, prefetch=2)
    ckpt.close()
    assert int(resumed.step) == 8
    assert _equal(_leaves(ref), _leaves(resumed))


def test_resume_restores_the_generator_exactly(tmp_path):
    """A model that draws dropout masks from the state's generator: the
    resumed run replays the same masks only because the generator's
    state was saved and restored."""
    trainer, ref_state, batches = _make(cls=DropoutMLP)
    ref = trainer.fit(ref_state, batches, epochs=2, sync_every=2)
    _, s_a, _ = _make(cls=DropoutMLP)
    ckpt = CheckpointManager(str(tmp_path / "gen"))
    with FaultInjector.seeded(
            0, preemption=Fault(when=lambda c: c["step"] == 6)):
        with pytest.raises(InjectedFault):
            trainer.fit(s_a, batches, epochs=2, checkpoint=ckpt,
                        checkpoint_every=3)
    _, s_b, _ = _make(cls=DropoutMLP)
    restored = ckpt.restore(s_b)
    assert torch.equal(restored.rng.get_state(),
                       ckpt.restore(s_b, step=6).rng.get_state())
    assert not torch.equal(restored.rng.get_state(), s_b.rng.get_state())
    resumed = trainer.fit(s_b, batches, epochs=2, checkpoint=ckpt)
    assert _equal(_leaves(ref), _leaves(resumed))
    assert torch.equal(ref.rng.get_state(), resumed.rng.get_state())
    ckpt.close()


def test_staging_overlaps_training_steps():
    trainer, state, batches = _make()
    main = threading.get_ident()
    dispatched = threading.Event()
    overlapped = threading.Event()
    source_threads = []

    class Stream:
        def __iter__(self):
            for i, pair in enumerate(batches):
                source_threads.append(threading.get_ident())
                if i >= 1 and dispatched.wait(timeout=10.0):
                    overlapped.set()
                yield pair

    class Logger(MetricsLogger):
        def log_step(self, step, metrics, examples=None, defer=False):
            dispatched.set()
            return super().log_step(step, metrics, examples=examples,
                                    defer=defer)

    logger = Logger(sinks=[lambda r: None])
    fitted = trainer.fit(state, Stream(), epochs=1, metrics_logger=logger,
                         sync_every=100, prefetch=2)
    assert overlapped.is_set()
    assert all(t != main for t in source_threads)
    assert int(fitted.step) == len(batches)
    assert [r["step"] for r in logger.history] == [1, 2, 3, 4]
    assert all(isinstance(r["loss"], float) for r in logger.history)
    # one sync at the epoch's end: the loop never waited between
    assert trainer.fit_stats["syncs"] == 1
    assert trainer.fit_stats["steps"] == 4


def test_serial_fallback_stages_on_main_thread():
    trainer, state, batches = _make()
    main = threading.get_ident()
    source_threads = []

    class Stream:
        def __iter__(self):
            for pair in batches:
                source_threads.append(threading.get_ident())
                yield pair

    trainer.fit(state, Stream(), epochs=1, prefetch=0)
    assert source_threads and all(t == main for t in source_threads)


def test_stream_error_propagates_and_flushes(tmp_path):
    class DecodeBoom(RuntimeError):
        pass

    trainer, state, batches = _make()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))

    class Stream:
        def __iter__(self):
            yield batches[0]
            yield batches[1]
            raise DecodeBoom("partition 2 unreadable")

    with pytest.raises(DecodeBoom, match="partition 2 unreadable"):
        trainer.fit(state, Stream(), epochs=1, checkpoint=ckpt,
                    checkpoint_every=1, sync_every=100, prefetch=2)
    assert ckpt.latest_step() == 2
    ckpt.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and [
            t for t in threading.enumerate()
            if t.name.startswith("sparkdl-prefetch")]:
        time.sleep(0.01)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("sparkdl-prefetch")]


def test_deferred_metrics_rate_is_window_averaged():
    trainer, state, batches = _make()
    logger = MetricsLogger(sinks=[lambda r: None])
    trainer.fit(state, batches, epochs=2, metrics_logger=logger,
                sync_every=4, prefetch=2)
    assert len(logger.history) == 8
    assert "examples_per_sec" not in logger.history[0]
    assert any("examples_per_sec" in r for r in logger.history[4:])


def test_preemption_abort_with_deferred_sync_resumes_exact(tmp_path):
    trainer, ref_state, batches = _make()
    ref = trainer.fit(ref_state, batches, epochs=2, sync_every=8,
                      prefetch=2)
    _, s_a, _ = _make()
    ckpt = CheckpointManager(str(tmp_path / "c"))
    logger = MetricsLogger(sinks=[lambda r: None])
    with FaultInjector.seeded(
            0, preemption=Fault(when=lambda c: c["step"] == 3)) as inj:
        with pytest.raises(InjectedFault):
            trainer.fit(s_a, batches, epochs=2, checkpoint=ckpt,
                        checkpoint_every=2, sync_every=8, prefetch=2,
                        metrics_logger=logger)
    assert inj.fired["preemption"] == 1
    assert ckpt.latest_step() == 2
    assert [r["step"] for r in logger.history] == [1, 2, 3]
    _, s_b, _ = _make()
    resumed = trainer.fit(s_b, batches, epochs=2, checkpoint=ckpt,
                          sync_every=8, prefetch=2)
    ckpt.close()
    assert int(resumed.step) == 8
    assert _equal(_leaves(ref), _leaves(resumed))


def test_on_step_sees_completed_host_steps():
    trainer, state, batches = _make()
    seen = []
    trainer.fit(state, batches, epochs=2, on_step=seen.append,
                sync_every=50, prefetch=2)
    assert seen == list(range(1, 9))


def test_evaluate_weights_batches_by_size():
    trainer, state, batches = _make()
    x, _, y = _toy_data()
    out = trainer.evaluate(state, [(x[:10], y[:10]), (x[10:16], y[10:16])])
    whole = trainer.evaluate(state, [(x[:16], y[:16])])
    assert set(out) == {"val_loss", "val_accuracy"}
    assert out["val_loss"] == pytest.approx(whole["val_loss"], rel=1e-6)
    assert trainer.evaluate(state, []) == {}


def test_fit_records_the_references_telemetry_names():
    from sparkdl_tpu_torch.core import telemetry

    trainer, state, batches = _make()
    with telemetry.Telemetry("fit") as tel:
        trainer.fit(state, batches, epochs=2, sync_every=2)
    report = tel.report()
    names = set(report["trace"]["by_name"])
    assert {telemetry.SPAN_FIT, telemetry.SPAN_EPOCH,
            "sparkdl.train_step"} <= names
    hist = report["metrics"]["histograms"]
    assert hist[telemetry.M_STEP_TIME_S]["count"] == 7
    assert hist[telemetry.M_STEPS_PER_SEC]["count"] >= 3


def test_debug_mode_raises_at_the_first_nan():
    trainer, state, batches = _make()
    x, y = batches[0]
    bad = [(np.full_like(x, np.nan), y)]
    with debug_mode():
        with pytest.raises(FloatingPointError, match="non-finite"):
            trainer.fit(state, bad, epochs=1)
    with debug_mode(nans=False, leaks=True):  # leaks: accepted, a no-op
        trainer.fit(state, bad, epochs=1)


def test_sparkdl_debug_env_checks_every_fit(monkeypatch):
    trainer, state, batches = _make()
    bad = [(np.full_like(batches[0][0], np.inf), batches[0][1])]
    monkeypatch.setenv("SPARKDL_DEBUG", "1")
    with pytest.raises(FloatingPointError):
        trainer.fit(state, bad, epochs=1)
    monkeypatch.setenv("SPARKDL_DEBUG", "0")
    trainer.fit(state, bad, epochs=1)
