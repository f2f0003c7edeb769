"""The port's CheckpointManager: manifest, fence, fallback, async save.

Counterparts of the JAX package's
``tests/train/test_checkpoint_integrity.py`` and of
``tests/train/test_resilience_train.py`` but its runner tests (the gang
restarts of ``TPURunner`` are driven here by a plain retry loop, since
the runner waits for the distributed slice): the sha256 manifest inside
each step, bit rot refused, fallback past corrupt steps, the
monotonic fence refusing a superseded writer, overwrite of a recomputed
step, resume after a preemption bit for bit. Plus what the port adds: an
asynchronous save copies the state before it returns (PyTorch updates
parameters in place), retention, and the structure check.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from torch import nn

from sparkdl_tpu_torch.core import health, resilience
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
from sparkdl_tpu_torch.train import CheckpointManager, Trainer

LOGGER = "sparkdl_tpu_torch.train.checkpoint"


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    monkeypatch.setattr(EngineConfig, "device", "cpu")


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc1 = nn.Linear(4, 8)
        self.fc2 = nn.Linear(8, 3)

    def forward(self, x):
        return torch.softmax(self.fc2(torch.relu(self.fc1(x))), dim=-1)


def _data(n=32, d=4):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return [(x[i:i + 8], y[i:i + 8]) for i in range(0, n, 8)]


def _fresh(optimizer="sgd"):
    return Trainer.from_module(MLP(), optimizer=optimizer,
                               learning_rate=0.1)


@pytest.fixture
def host_state():
    return _fresh("adam")[1]


def _same(a, b):
    return (int(a.step) == int(b.step)
            and all(torch.equal(a.params[k], b.params[k]) for k in a.params)
            and torch.equal(a.rng.get_state(), b.rng.get_state()))


def _bit_flip_one_data_file(directory, step):
    """Flip one byte mid-file in the step's largest non-manifest file —
    size unchanged, so only a checksum can tell."""
    step_dir = os.path.join(directory, str(step))
    candidates = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            if name == "sparkdl.sums.json":
                continue
            path = os.path.join(root, name)
            candidates.append((os.path.getsize(path), path))
    size, path = max(candidates)
    raw = bytearray(open(path, "rb").read())
    raw[size // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    return path


# -- test_checkpoint_integrity.py counterparts --------------------------------

def test_sync_save_writes_manifest_inside_step_dir(tmp_path, host_state):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, host_state, synchronous=True)
    manifest = tmp_path / "ck" / "1" / "sparkdl.sums.json"
    assert manifest.exists()
    data = json.loads(manifest.read_text())
    assert data["step"] == 1 and data["files"]
    assert set(os.listdir(tmp_path / "ck")) == {"1"}  # no temp dir left
    assert ckpt.step_bytes(1) > 0
    ckpt.close()


def test_bit_flip_rejected_by_checksum_explicit_step(tmp_path, host_state):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, host_state, synchronous=True)
    _bit_flip_one_data_file(ckpt.directory, 1)
    with HealthMonitor() as mon:
        with pytest.raises(IOError, match="checksum verification"):
            ckpt.restore(host_state, step=1)
    assert mon.events(health.CHECKPOINT_CHECKSUM_REJECTED)
    ckpt.close()


def test_bit_flip_falls_back_to_previous_step(tmp_path, host_state,
                                              caplog):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, host_state, synchronous=True)
    ckpt.save(2, host_state, synchronous=True)
    _bit_flip_one_data_file(ckpt.directory, 2)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        restored = ckpt.restore(host_state)
    assert _same(restored, host_state)
    assert any("step 2" in r.message and "falling back" in r.message
               for r in caplog.records)
    ckpt.close()


def test_manifestless_step_restores_without_verification(tmp_path,
                                                         host_state):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, host_state, synchronous=True)
    os.unlink(os.path.join(ckpt.directory, "1", "sparkdl.sums.json"))
    assert _same(ckpt.restore(host_state, step=1), host_state)
    ckpt.close()


def test_stale_incarnation_save_refused(tmp_path, host_state):
    old = CheckpointManager(str(tmp_path / "ck"))
    old.save(1, host_state, synchronous=True)
    new = CheckpointManager(str(tmp_path / "ck"))  # supersedes `old`
    with HealthMonitor() as mon:
        with pytest.raises(resilience.StaleCheckpointWriter) as ei:
            old.save(2, host_state, synchronous=True)
    assert mon.events(health.CHECKPOINT_FENCED)
    assert resilience.classify(ei.value) == resilience.FATAL
    new.save(2, host_state, synchronous=True)
    assert new.all_steps() == [1, 2]
    new.close()
    old.close()


def test_async_save_superseded_before_its_publish_is_refused(
        tmp_path, host_state, monkeypatch):
    """A zombie's asynchronous save, queued before its successor claimed
    the directory and written after, is refused at the publish: the step
    never lands and the refusal surfaces at the barrier."""
    import threading

    from sparkdl_tpu_torch.train import checkpoint

    writing, release = threading.Event(), threading.Event()
    real_save = checkpoint.torch.save

    def slow_save(obj, f):
        writing.set()
        assert release.wait(10.0)
        real_save(obj, f)

    old = CheckpointManager(str(tmp_path / "ck"))
    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    old.save(3, host_state)                      # queued, then blocks
    assert writing.wait(10.0)
    new = CheckpointManager(str(tmp_path / "ck"))  # supersedes `old`
    release.set()
    with pytest.raises(resilience.StaleCheckpointWriter):
        old.wait_until_finished()
    assert new.all_steps() == []
    assert not [n for n in os.listdir(new.directory) if n.startswith(".")]
    old.close()
    new.close()


def test_fence_token_is_monotonic_per_directory(tmp_path):
    a = CheckpointManager(str(tmp_path / "ck"))
    b = CheckpointManager(str(tmp_path / "ck"))
    c = CheckpointManager(str(tmp_path / "ck"))
    assert a._incarnation < b._incarnation < c._incarnation
    fence = json.loads((tmp_path / "ck.fence.json").read_text())
    assert fence["incarnation"] == c._incarnation
    for m in (a, b, c):
        m.close()
    other = CheckpointManager(str(tmp_path / "other"))
    assert other._incarnation == 1
    other.close()


# -- test_resilience_train.py counterparts (its runner tests aside) ----------

def _fit_with_checkpoints(tmp_path, name="ck"):
    trainer, state = _fresh()
    ckpt = CheckpointManager(str(tmp_path / name))
    state = trainer.fit(state, _data(), epochs=1, checkpoint=ckpt,
                        checkpoint_every=1)
    ckpt.wait_until_finished()
    return ckpt, state


def test_corrupt_latest_checkpoint_falls_back_with_warning(tmp_path,
                                                           caplog):
    ckpt, state = _fit_with_checkpoints(tmp_path)
    assert ckpt.all_steps() == [2, 3, 4]  # keep=3
    ckpt._truncate_step(4)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        restored = ckpt.restore(state)
    assert int(restored.step) == 3
    assert any("step 4" in r.message and "falling back" in r.message
               for r in caplog.records)
    ckpt.close()


def test_checkpoint_truncate_injection_point(tmp_path, caplog):
    _, state = _fresh()
    ckpt = CheckpointManager(str(tmp_path / "inj"))
    ckpt.save(1, state, synchronous=True)
    with FaultInjector.seeded(0, checkpoint_truncate=1) as inj:
        ckpt.save(2, state, synchronous=True)
    assert inj.fired["checkpoint_truncate"] == 1
    with caplog.at_level(logging.WARNING):
        restored = ckpt.restore(state)
    assert _same(restored, state)
    assert any("falling back to step 1" in r.message
               for r in caplog.records)
    ckpt.close()


def test_save_over_existing_step_overwrites(tmp_path):
    ckpt, state = _fit_with_checkpoints(tmp_path, name="overwrite")
    latest = ckpt.latest_step()
    ckpt._truncate_step(latest)
    ckpt.close()
    ckpt2 = CheckpointManager(str(tmp_path / "overwrite"))
    with pytest.raises(Exception):
        ckpt2.restore(state, step=latest)
    ckpt2.save(latest, state, synchronous=True)
    assert _same(ckpt2.restore(state, step=latest), state)
    ckpt2.close()


def test_all_checkpoints_corrupt_raises(tmp_path):
    ckpt, state = _fit_with_checkpoints(tmp_path, name="allbad")
    for step in ckpt.all_steps():
        ckpt._truncate_step(step)
    with pytest.raises(Exception):
        ckpt.restore(state)
    ckpt.close()


def test_explicit_step_restore_does_not_fall_back(tmp_path):
    ckpt, state = _fit_with_checkpoints(tmp_path, name="explicit")
    ckpt._truncate_step(4)
    with pytest.raises(Exception):
        ckpt.restore(state, step=4)
    ckpt.close()


def _restarting(train_fn, max_restarts):
    """A plain retry loop in place of TPURunner: retry what the
    taxonomy calls retryable, up to ``max_restarts`` times."""
    for attempt in range(max_restarts + 1):
        try:
            return train_fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if (resilience.classify(e) != resilience.RETRYABLE
                    or attempt == max_restarts):
                raise


@pytest.mark.parametrize("every,redone", [(1, []), (2, [3])])
def test_preemption_resumes_from_latest_checkpoint(tmp_path, every, redone):
    """checkpoint_every=1 loses no step; checkpoint_every=2 with the
    preemption at step 3 redoes exactly step 3."""
    steps_run, attempts = [], []

    def train_fn():
        attempts.append(1)
        trainer, state = _fresh()
        ckpt = CheckpointManager(str(tmp_path / f"gang{every}"))
        state = trainer.fit(state, _data(), epochs=2, checkpoint=ckpt,
                            checkpoint_every=every,
                            on_step=steps_run.append)
        ckpt.close()
        return int(state.step)

    with FaultInjector.seeded(
            0, preemption=Fault(when=lambda c: c["step"] == 3)) as inj:
        assert _restarting(train_fn, max_restarts=2) == 8
    assert inj.fired["preemption"] == 1 and len(attempts) == 2
    assert steps_run == [1, 2, 3] + redone + [4, 5, 6, 7, 8]


def test_resume_after_preemption_matches_uninterrupted_run(tmp_path):
    def run(ckpt_dir, inject):
        def train_fn():
            trainer, state = _fresh()
            ckpt = CheckpointManager(ckpt_dir)
            state = trainer.fit(state, _data(), epochs=1, checkpoint=ckpt,
                                checkpoint_every=1)
            ckpt.close()
            return state

        if inject:
            with FaultInjector.seeded(
                    0, preemption=Fault(when=lambda c: c["step"] == 2)):
                return _restarting(train_fn, max_restarts=1)
        return train_fn()

    plain = run(str(tmp_path / "plain"), inject=False)
    resumed = run(str(tmp_path / "preempted"), inject=True)
    assert all(torch.equal(plain.params[k], resumed.params[k])
               for k in plain.params)


# -- what the port adds -------------------------------------------------------

def test_async_save_copies_the_state_before_returning(tmp_path):
    """The step updates params in place: an asynchronous save must hold
    the values of the moment it was called, not of the next steps."""
    trainer, state = _fresh()
    ckpt = CheckpointManager(str(tmp_path / "async"))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    ckpt.save(0, state)                       # asynchronous
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)                        # the next "step"
    ckpt.wait_until_finished()
    _, template = _fresh()
    restored = ckpt.restore(template, step=0)
    assert all(torch.equal(restored.params[k], before[k]) for k in before)
    ckpt.close()


def test_restore_refuses_another_structure(tmp_path, host_state):
    ckpt = CheckpointManager(str(tmp_path / "shape"))
    ckpt.save(1, host_state, synchronous=True)
    _, sgd_state = _fresh("sgd")             # no adam moments
    with pytest.raises(ValueError, match="train-state structure"):
        ckpt.restore(sgd_state, step=1)
    ckpt.close()


def test_restored_state_holds_every_component(tmp_path, host_state):
    trainer, state = _fresh("adam")
    state = trainer.fit(state, _data(), epochs=1)
    ckpt = CheckpointManager(str(tmp_path / "all"))
    ckpt.save(int(state.step), state, synchronous=True)
    restored = ckpt.restore(host_state)
    assert _same(restored, state)
    for slot in ("mu", "nu"):
        assert all(torch.equal(restored.opt_state[slot][k],
                               state.opt_state[slot][k])
                   for k in state.opt_state[slot])
    assert int(restored.opt_state["count"]) == 4
    ckpt.close()
