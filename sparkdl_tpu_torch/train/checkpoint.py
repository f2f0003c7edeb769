"""Checkpoint/resume of the full training state.

A port of ``sparkdl_tpu.train.checkpoint``, on ``torch.save`` in place of
Orbax. Every training state component ``{step, params, opt_state,
model_state, rng}`` is saved (optionally asynchronously) and restored
exactly, which is what makes a restarted fit replay to the same result.

- **Atomic steps**: a step is written into a temporary directory beside
  the steps, its files fsynced, then published by ``os.replace`` as
  ``<directory>/<step>`` and the directory fsynced, so a crash mid-write
  never leaves a half-step that :meth:`latest_step` would report.
- **Per-file checksums**: each step directory holds a sha256 manifest
  (``sparkdl.sums.json``, written before the publish, so retention
  deletes it with the step); ``restore`` verifies it before reading a
  byte, catching silent bit rot as well as truncation. A step without a
  manifest (written by another tool, or whose manifest was shredded)
  restores unverified.
- **Fencing token**: constructing a manager claims the next monotonic
  incarnation for the directory (``<directory>.fence.json``); every
  ``save`` re-checks it, and each write again just before its publish,
  so a superseded writer (a zombie of a restarted attempt, still
  flushing asynchronous saves) is refused with
  :class:`~sparkdl_tpu_torch.core.resilience.StaleCheckpointWriter`.
- **Fallback**: ``restore`` with no step walks retained steps
  newest-first past corrupt ones (bit rot, torn disks, the injected
  ``checkpoint_truncate`` fault) with a warning naming each skipped step.
  An explicit step does not fall back.

PyTorch updates parameters in place (the reference's arrays are
immutable), so ``save`` copies the state to host memory before it
returns, synchronous or not: the next step cannot race the writer.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional

import torch

from sparkdl_tpu_torch.core import health, resilience

logger = logging.getLogger(__name__)

# Checksum manifest filename, stored INSIDE the step directory.
_SUMS_NAME = "sparkdl.sums.json"
_STATE_NAME = "state.pt"
_GENERATOR = "__generator__"


def to_host(obj: Any) -> Any:
    """``obj`` (a TrainState, or dicts, lists and tuples of tensors,
    generators and numbers) as a tree ``torch.save`` writes and
    ``torch.load(weights_only=True)`` reads: every tensor a CPU copy
    that later in-place updates of the original cannot reach; a
    generator its state; a dataclass a dict of its fields."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, torch.Generator):
        return {_GENERATOR: obj.get_state(), "device": str(obj.device)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_host(v) for v in obj]
    return obj


def from_host(payload: Any, template: Any, path: str = "state") -> Any:
    """Rebuild ``template``'s structure from a :func:`to_host` tree: each
    tensor onto its template's device (shape and dtype must agree), each
    generator a new one of its template's device with the saved state.
    A mismatch raises ``ValueError`` naming the first differing path."""
    def mismatch(why: str) -> ValueError:
        return ValueError(f"{path}: {why}")

    if isinstance(template, torch.Tensor):
        if not isinstance(payload, torch.Tensor):
            raise mismatch(f"expected a tensor, got {type(payload).__name__}")
        if payload.shape != template.shape or payload.dtype != template.dtype:
            raise mismatch(
                f"saved {tuple(payload.shape)} {payload.dtype}, template "
                f"{tuple(template.shape)} {template.dtype}")
        return payload.to(template.device)
    if isinstance(template, torch.Generator):
        if not (isinstance(payload, dict) and _GENERATOR in payload):
            raise mismatch("expected a generator state")
        gen = torch.Generator(device=template.device)
        gen.set_state(payload[_GENERATOR])
        return gen
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(payload, dict) or set(payload) != set(names):
            have = (sorted(payload) if isinstance(payload, dict)
                    else type(payload).__name__)
            raise mismatch(f"expected fields {names}, got {have}")
        return type(template)(**{
            n: from_host(payload[n], getattr(template, n), f"{path}.{n}")
            for n in names})
    if isinstance(template, dict):
        if not isinstance(payload, dict) or set(payload) != set(template):
            have = sorted(payload) if isinstance(payload, dict) else payload
            raise mismatch(f"expected keys {sorted(template)}, got {have}")
        return {k: from_host(payload[k], v, f"{path}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(payload, (list, tuple)) \
                or len(payload) != len(template):
            raise mismatch(f"expected {len(template)} items")
        return type(template)(from_host(p, t, f"{path}[{i}]")
                              for i, (p, t) in enumerate(zip(payload,
                                                             template)))
    return payload


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_sums(step_dir: str) -> Dict[str, str]:
    """sha256 of every file under ``step_dir`` (manifest excluded), keyed
    by relative path."""
    sums: Dict[str, str] = {}
    for root, _dirs, files in os.walk(step_dir):
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            if rel == _SUMS_NAME:
                continue
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            sums[rel] = h.hexdigest()
    return sums


class CheckpointManager:
    """Step-indexed checkpoints under one directory.

    ``keep`` bounds retained steps (the newest ``keep``); ``save`` writes
    on a background thread (overlapping the next train steps) unless
    ``synchronous=True`` is passed.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        # Steps THIS manager wrote: re-saving one (e.g. fit's final
        # synchronous save right after the per-step save of the same
        # step) is a no-op, not an overwrite.
        self._saved_steps: set = set()
        self._lock = threading.Lock()
        self._writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []
        self._fence_path = self.directory + ".fence.json"
        self._incarnation = self._claim_fence()

    # -- fencing -------------------------------------------------------------

    def _claim_fence(self) -> int:
        """Claim the next incarnation of this directory (read, increment,
        atomic replace)."""
        try:
            with open(self._fence_path, encoding="utf-8") as f:
                current = int(json.load(f)["incarnation"])
        except (OSError, ValueError, KeyError, TypeError):
            current = 0
        incarnation = current + 1
        tmp = f"{self._fence_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"incarnation": incarnation}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._fence_path)
        return incarnation

    def _check_fence(self, step: int) -> None:
        try:
            with open(self._fence_path, encoding="utf-8") as f:
                latest = int(json.load(f)["incarnation"])
        except (OSError, ValueError, KeyError, TypeError):
            return  # an unreadable token never blocks a save
        if latest > self._incarnation:
            health.record(health.CHECKPOINT_FENCED, step=step,
                          incarnation=self._incarnation, latest=latest)
            raise resilience.StaleCheckpointWriter(
                f"checkpoint save of step {step} refused: this writer "
                f"holds incarnation {self._incarnation} of "
                f"{self.directory} but incarnation {latest} has claimed "
                "it — a superseded attempt must not clobber its "
                "successor's checkpoints")

    # -- saving --------------------------------------------------------------

    def save(self, step: int, state: Any, synchronous: bool = False) -> None:
        self._check_fence(step)
        step = int(step)
        if step not in self._saved_steps:
            host = to_host(state)  # before returning: the caller mutates
            if synchronous:
                self.wait_until_finished()
                self._write(step, host)
            else:
                with self._lock:
                    if self._writer is None:
                        self._writer = concurrent.futures.ThreadPoolExecutor(
                            1, thread_name_prefix="sparkdl-ckpt")
                    self._pending.append(
                        self._writer.submit(self._write, step, host))
            self._saved_steps.add(step)
        if synchronous:
            self.wait_until_finished()
            if step not in self.all_steps():
                raise IOError(
                    f"checkpoint step {step} under {self.directory} was not "
                    "committed (crash/IO failure mid-write?)")
        if resilience.should_fire("checkpoint_truncate", step=step):
            # corrupt the just-written step in place (truncate every file
            # to half): bit rot / a torn write on a COMMITTED checkpoint
            self.wait_until_finished()
            self._truncate_step(step)

    def _write(self, step: int, host: Any) -> None:
        """Write one step atomically: a temporary directory, fsynced, then
        ``os.replace``; an existing step (a restarted run recomputed it)
        is replaced. Then retention."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{os.getpid()}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, _STATE_NAME), "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            payload = json.dumps({"step": step, "files": _file_sums(tmp)},
                                 sort_keys=True).encode()
            with open(os.path.join(tmp, _SUMS_NAME), "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # again at the publish: an asynchronous save queued before a
            # successor claimed the directory must not land after it
            self._check_fence(step)
            if os.path.exists(final):
                logger.warning(
                    "checkpoint step %d already exists under %s (a restart "
                    "recomputed it); overwriting", step, self.directory)
                trash = f"{tmp}.old"
                os.replace(final, trash)
                os.replace(tmp, final)
                shutil.rmtree(trash, ignore_errors=True)
            else:
                os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until every asynchronous save has landed; the first
        failed one raises here."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            with self._lock:
                writer, self._writer = self._writer, None
            if writer is not None:
                writer.shutdown(wait=True)

    # -- checksums and corruption ---------------------------------------------

    def _verify_sums(self, step: int) -> None:
        """Refuse a restore whose bytes do not match the step's manifest;
        a missing or unreadable manifest skips verification."""
        step_dir = os.path.join(self.directory, str(step))
        try:
            with open(os.path.join(step_dir, _SUMS_NAME),
                      encoding="utf-8") as f:
                recorded = json.load(f)["files"]
        except (OSError, ValueError, KeyError, TypeError):
            return
        if not isinstance(recorded, dict):
            return
        actual = _file_sums(step_dir)
        mismatched = sorted(k for k in set(recorded) | set(actual)
                            if recorded.get(k) != actual.get(k))
        if mismatched:
            health.record(health.CHECKPOINT_CHECKSUM_REJECTED, step=step,
                          files=len(mismatched))
            raise IOError(
                f"checkpoint step {step} under {self.directory} failed "
                f"checksum verification ({len(mismatched)} file(s), e.g. "
                f"{mismatched[0]!r}) — refusing to restore corrupted "
                "state")

    def _truncate_step(self, step: int) -> None:
        step_dir = os.path.join(self.directory, str(step))
        for root, _dirs, files in os.walk(step_dir):
            for name in files:
                path = os.path.join(root, name)
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(size // 2)
        logger.warning("FaultInjector: truncated checkpoint step %d files "
                       "under %s", step, step_dir)

    # -- reading -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_bytes(self, step: int) -> int:
        """Bytes on disk of one step, its manifest included."""
        step_dir = os.path.join(self.directory, str(step))
        return sum(os.path.getsize(os.path.join(root, n))
                   for root, _dirs, files in os.walk(step_dir)
                   for n in files)

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the template's structure (and devices).

        With an explicit ``step``, exactly that step is restored (a
        failure raises). With ``step=None``, retained steps are tried
        newest-first: a corrupt/partial step logs a warning naming it and
        falls back to the previous retained step; only when every
        retained step fails does the newest step's error propagate.
        """
        self.wait_until_finished()
        if step is not None:
            return self._restore_step(int(step), state_template)
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(
                f"No checkpoint found under {self.directory}")
        first_err: Optional[BaseException] = None
        for i, candidate in enumerate(steps):
            try:
                return self._restore_step(candidate, state_template)
            except Exception as e:  # noqa: BLE001 - corrupt data raises
                # anything (zip errors, unpickling, OSError)
                first_err = first_err or e
                if i + 1 >= len(steps):
                    raise first_err
                logger.warning(
                    "checkpoint step %d under %s failed to restore "
                    "(%s: %s); falling back to step %d", candidate,
                    self.directory, type(e).__name__, e, steps[i + 1])

    def _restore_step(self, step: int, state_template: Any) -> Any:
        self._verify_sums(step)
        path = os.path.join(self.directory, str(step), _STATE_NAME)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        try:
            return from_host(payload, state_template)
        except ValueError as e:
            raise ValueError(
                f"Checkpoint under {self.directory} (step {step}) does not "
                "match the current train-state structure (another model, "
                "optimizer or optimizer-state format); delete the "
                "checkpoint directory to restart training from scratch. "
                f"Original error: {e}") from e
