"""Durable job recovery: a write-ahead partition journal and atomic spills.

The port of ``sparkdl_tpu.core.durability``. A partition committed by a
job that later dies (``kill -9``, a lost machine) is not computed again
when the same job runs again: it is read back from its spill, verified
against the hash its journal record holds, and served bit for bit in
its place.

Design, as in the reference:

- **Job identity.** :func:`job_id` hashes the plan: the input
  partitions' spill bytes, the column names, a fingerprint of the op
  chain (each op's qualname and the values its closure holds) and the
  quarantine knobs. The same frame built the same way in a restarted
  process maps to the same journal directory; a change to the inputs,
  the ops or the semantics gets a fresh journal. The fingerprint sees an
  op's own closure cells, not what the functions in them close over,
  and a value whose repr would embed an address (a ``ModelFunction``) or
  read the card (a tensor: only its dtype, shape and device count) adds
  no more than its type. So two jobs over the same inputs whose op
  chains differ only in such a value, say two featurizers of one model
  with different weights, share a job id: scope ``durable_dir`` to one
  logical job.
- **Write-ahead journal.** ``<durable_dir>/<job_id>/journal.jsonl``
  holds one record per committed partition (index, attempts, spill
  name, sha256 of the spill, quarantine verdict). Every rewrite goes
  through a temporary file, fsync, ``os.replace`` and a directory
  fsync, and every line carries its own digest: a torn or altered
  record is detected and discarded, never trusted.
- **Spill before journal.** A finished partition is encoded
  (:func:`encode_batch`), written atomically to ``part-<i>.spill`` and
  only then recorded; so a record always names a whole spill. On
  restart :meth:`PartitionJournal.resume` checks every spill against
  its hash; the verified partitions load from disk in their places and
  only the rest run.
- **Exactly once.** A commit is idempotent (a hedge that loses commits
  nothing) and quarantine verdicts are committed, so a poisoned
  partition stays quarantined across restarts.

The spill format is the port's own: the reference spills Arrow IPC, and
a port partition is a :class:`~sparkdl_tpu_torch.engine.dataframe.Batch`
of numpy arrays, Python lists and
:class:`~sparkdl_tpu_torch.image.imageIO.ImageColumn`. An encoding is a
magic line, the length of a JSON header, the header (columns in order,
each with its kind, and the values of list columns as tagged JSON) and
the binary buffers the header points into: every array in ``.npy``
format (read back with ``np.load(..., allow_pickle=False)``) and every
``bytes`` value raw. No pickle is written or read. The same batch gives
the same bytes in every process, which keeps :func:`job_id` stable
across a restart, and the hash is taken over exactly the spilled bytes.
The cluster plane ships partitions in the same encoding.

The ``process_kill`` injection point fires right after a record
commits and SIGKILLs this process.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import signal
import struct
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

from sparkdl_tpu_torch.core import health, resilience

logger = logging.getLogger(__name__)

_JOURNAL = "journal.jsonl"
_RUN_ID_FILE = "run_id"
_MAGIC = b"SPARKDL-BATCH 1\n"
_LEN = struct.Struct("<Q")

# milliseconds of each commit (spill + journal) and of each journal
# rewrite, and the bytes spilled, in this process since the last reset
_stats_lock = threading.Lock()
_stats: Dict[str, Any] = {"commit_ms": [], "rewrite_ms": [],
                          "spill_bytes": 0}


def commit_stats() -> Dict[str, Any]:
    """A copy of this process's commit and rewrite milliseconds and
    spilled bytes, over every journal, since :func:`reset_commit_stats`."""
    with _stats_lock:
        return {"commit_ms": list(_stats["commit_ms"]),
                "rewrite_ms": list(_stats["rewrite_ms"]),
                "spill_bytes": _stats["spill_bytes"]}


def reset_commit_stats() -> None:
    with _stats_lock:
        _stats.update(commit_ms=[], rewrite_ms=[], spill_bytes=0)


# ---------------------------------------------------------------------------
# Atomic file helpers
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # no directory fds here; the rename is still atomic
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, payload: bytes) -> None:
    """Put ``payload`` at ``path`` through a temporary file, fsync and
    ``os.replace``: a reader sees the old content or the new, never a
    torn file, and the directory fsync makes the rename durable."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


# ---------------------------------------------------------------------------
# The spill format
# ---------------------------------------------------------------------------

class _Encoder:
    """Collects the binary buffers of one batch while its header is
    built."""

    def __init__(self) -> None:
        self.buffers: List[bytes] = []

    def buffer(self, payload: bytes) -> int:
        self.buffers.append(bytes(payload))
        return len(self.buffers) - 1

    def array(self, arr: np.ndarray) -> int:
        if arr.dtype == object:
            raise TypeError("an object array has no byte encoding; "
                            "encode it as a list column")
        out = io.BytesIO()
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")  # one layout: the same bytes
        np.lib.format.write_array(out, arr, version=(1, 0),
                                  allow_pickle=False)
        return self.buffer(out.getvalue())

    def value(self, v: Any) -> Any:
        """One list cell as JSON: None, bool, int, float and str as
        themselves, a list as a list, anything else as a one-key object
        naming its kind."""
        if v is None or isinstance(v, (bool, str)):
            return v
        if isinstance(v, int) and type(v) is int:
            return v
        if isinstance(v, float) and type(v) is float:
            return v
        if isinstance(v, list):
            return [self.value(x) for x in v]
        if isinstance(v, tuple):
            return {"tuple": [self.value(x) for x in v]}
        if isinstance(v, (bytes, bytearray)):
            return {"bytes": self.buffer(v)}
        if isinstance(v, np.ndarray):
            if v.dtype == object:
                return {"objarray": [self.value(x) for x in v.tolist()]}
            return {"ndarray": self.array(v)}
        if isinstance(v, np.generic):
            return {"scalar": self.array(np.asarray(v))}
        if isinstance(v, dict):
            return {"dict": [[self.value(k), self.value(x)]
                             for k, x in v.items()]}
        raise TypeError(f"a spilled cell cannot hold a {type(v).__name__}")

    def column(self, col: Any) -> Dict[str, Any]:
        from sparkdl_tpu_torch.image.imageIO import ImageColumn

        if isinstance(col, ImageColumn):
            desc = {"kind": "image", "origin": self.value(list(col.origin))}
            for field in ("height", "width", "nChannels", "mode", "valid"):
                desc[field] = self.array(getattr(col, field))
            if col.block is not None:
                desc["block"] = self.array(col.block)
            else:
                desc["data"] = self.value(list(col.data))
            return desc
        if isinstance(col, np.ndarray):
            if col.dtype == object:
                return {"kind": "objarray",
                        "values": [self.value(x) for x in col.tolist()]}
            return {"kind": "array", "array": self.array(col)}
        if isinstance(col, list):
            return {"kind": "list", "values": self.value(col)}
        raise TypeError(f"a spilled column cannot be a {type(col).__name__}")


class _Decoder:
    def __init__(self, buffers: List[memoryview]) -> None:
        self.buffers = buffers

    def array(self, index: int) -> np.ndarray:
        return np.load(io.BytesIO(self.buffers[index]), allow_pickle=False)

    def value(self, v: Any) -> Any:
        if isinstance(v, list):
            return [self.value(x) for x in v]
        if not isinstance(v, dict):
            return v
        (kind, payload), = v.items()
        if kind == "tuple":
            return tuple(self.value(x) for x in payload)
        if kind == "bytes":
            return bytes(self.buffers[payload])
        if kind == "ndarray":
            return self.array(payload)
        if kind == "objarray":
            return _object_array([self.value(x) for x in payload])
        if kind == "scalar":
            return self.array(payload)[()]
        if kind == "dict":
            return {self.value(k): self.value(x) for k, x in payload}
        raise IOError(f"unknown cell kind {kind!r} in a spilled batch")

    def column(self, desc: Dict[str, Any]) -> Any:
        from sparkdl_tpu_torch.image.imageIO import ImageColumn

        kind = desc["kind"]
        if kind == "array":
            return self.array(desc["array"])
        if kind == "list":
            return self.value(desc["values"])
        if kind == "objarray":
            return _object_array([self.value(x) for x in desc["values"]])
        if kind == "image":
            meta = {f: self.array(desc[f]) for f in
                    ("height", "width", "nChannels", "mode", "valid")}
            if "block" in desc:
                return ImageColumn(origin=self.value(desc["origin"]),
                                   block=self.array(desc["block"]), **meta)
            return ImageColumn(origin=self.value(desc["origin"]),
                               data=self.value(desc["data"]), **meta)
        raise IOError(f"unknown column kind {kind!r} in a spilled batch")


def _object_array(values: List[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def encode_batch(batch: Any) -> bytes:
    """One partition as bytes: the spill format and the cluster plane's
    wire format (the module docstring describes it). Deterministic: the
    same batch gives the same bytes in every process."""
    enc = _Encoder()
    header = {"num_rows": int(batch.num_rows),
              "columns": [[name, enc.column(col)]
                          for name, col in batch.columns.items()]}
    header["buffers"] = [len(b) for b in enc.buffers]
    head = json.dumps(header, sort_keys=True, separators=(",", ":"),
                      allow_nan=True).encode()
    return b"".join([_MAGIC, _LEN.pack(len(head)), head, *enc.buffers])


def decode_batch(payload: bytes) -> Any:
    """The partition :func:`encode_batch` encoded, as a ``Batch``."""
    from sparkdl_tpu_torch.engine.dataframe import Batch

    view = memoryview(payload)
    if bytes(view[:len(_MAGIC)]) != _MAGIC:
        raise IOError("not a spilled batch (bad magic)")
    at = len(_MAGIC)
    (head_len,) = _LEN.unpack_from(view, at)
    at += _LEN.size
    header = json.loads(bytes(view[at:at + head_len]))
    at += head_len
    buffers = []
    for size in header["buffers"]:
        buffers.append(view[at:at + size])
        at += size
    if at != len(view):
        raise IOError(f"spilled batch holds {len(view) - at} stray bytes")
    dec = _Decoder(buffers)
    return Batch({name: dec.column(desc) for name, desc in header["columns"]},
                 int(header["num_rows"]))


# ---------------------------------------------------------------------------
# Plan fingerprinting
# ---------------------------------------------------------------------------

def _stable_repr(v: Any) -> str:
    """A repr of an op closure's value that is the same in every process.

    Covers what engine ops close over (column names, callables, small
    config values). A torch tensor gives its dtype, shape and device
    (its repr would print values, copying them off the card), a module
    its class; an object whose repr embeds an address gives its type
    name. The module docstring says which jobs share an id therefore.
    """
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_stable_repr(x) for x in v) + "]"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_stable_repr(x) for x in v)) + "}"
    if isinstance(v, dict):
        items = sorted(((str(k), _stable_repr(x)) for k, x in v.items()))
        return "{" + ",".join(f"{k}:{x}" for k, x in items) + "}"
    torch = sys.modules.get("torch")
    if torch is not None:
        if isinstance(v, torch.Tensor):
            return (f"Tensor({str(v.dtype)},{tuple(v.shape)},"
                    f"{v.device.type})")
        if isinstance(v, torch.nn.Module):
            return type(v).__qualname__
    if callable(v):
        return getattr(v, "__qualname__", type(v).__qualname__)
    r = repr(v)
    return type(v).__qualname__ if " at 0x" in r else r


def _op_token(op: Any) -> str:
    """Fingerprint one engine op: its qualname and the values its
    closure holds, so ``select("a")`` and ``select("b")`` differ."""
    parts = [getattr(op, "__qualname__", type(op).__qualname__)]
    for cell in getattr(op, "__closure__", None) or ():
        try:
            parts.append(_stable_repr(cell.cell_contents))
        except ValueError:  # an empty cell
            parts.append("<empty>")
    return "|".join(parts)


def ops_token(ops: Sequence[Any]) -> str:
    """Fingerprint of an op chain alone (no input data): the cluster
    router keys the chains it ships on it, so a worker that holds a
    chain already is not sent it again."""
    h = hashlib.sha256()
    for op in ops:
        h.update(_op_token(op).encode())
        h.update(b"\x00")
    return h.hexdigest()[:20]


def job_id(partitions: Sequence[Any], columns: Optional[Sequence[str]],
           ops: Sequence[Any]) -> str:
    """The job's identity: a hash of the plan (inputs, column names, op
    chain) and of the knobs that change what it commits."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    h = hashlib.sha256()
    h.update(json.dumps(list(columns) if columns is not None else None)
             .encode())
    h.update(str(len(partitions)).encode())
    for batch in partitions:
        h.update(encode_batch(batch))
    for op in ops:
        h.update(_op_token(op).encode())
        h.update(b"\x00")
    h.update(json.dumps({
        "quarantine": bool(EngineConfig.quarantine),
        "quarantine_max_fatal": int(EngineConfig.quarantine_max_fatal),
    }, sort_keys=True).encode())
    return h.hexdigest()[:20]


# ---------------------------------------------------------------------------
# Journal records
# ---------------------------------------------------------------------------

def _record_line(rec: Dict[str, Any]) -> str:
    """One journal line: the record and its own digest, so a torn tail
    (a partial last line after a crash) is detected."""
    body = json.dumps(rec, sort_keys=True)
    crc = hashlib.sha256(body.encode()).hexdigest()[:8]
    return json.dumps({"rec": rec, "crc": crc}, sort_keys=True) + "\n"


def _check_record(line: str) -> Optional[Dict[str, Any]]:
    """Parse and verify one journal line; None for a torn or altered
    record."""
    try:
        obj = json.loads(line)
        rec, crc = obj["rec"], obj["crc"]
    except (ValueError, KeyError, TypeError):
        return None
    if not isinstance(rec, dict):
        return None
    body = json.dumps(rec, sort_keys=True)
    if hashlib.sha256(body.encode()).hexdigest()[:8] != crc:
        return None
    if (not isinstance(rec.get("partition"), int)
            or not isinstance(rec.get("sha256"), str)
            or not isinstance(rec.get("spill"), str)):
        return None
    return rec


class PartitionJournal:
    """The write-ahead journal and spill store of ONE durable job.

    Construct it (it loads an existing journal, dropping torn records),
    :meth:`resume` (verify the spills, get the committed set), then
    :meth:`commit` each newly finished partition and :meth:`load` each
    restored one. Thread-safe: partition threads commit concurrently.
    """

    def __init__(self, root: str, job: str, num_partitions: int) -> None:
        self.job_id = job
        self.dir = os.path.join(root, job)
        os.makedirs(self.dir, exist_ok=True)
        self._path = os.path.join(self.dir, _JOURNAL)
        self._lock = threading.Lock()
        self._records: Dict[int, Dict[str, Any]] = {}
        self._attempts: Dict[int, int] = {}
        self._num_partitions = num_partitions
        self._load()

    # -- the restart path ----------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self._path, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            return
        for line in lines:
            if not line:
                continue
            rec = _check_record(line)
            if rec is None:
                health.record(health.DURABLE_JOURNAL_TORN, job=self.job_id)
                logger.warning(
                    "durable journal %s: torn/corrupt record discarded",
                    self._path)
                continue
            self._records[rec["partition"]] = rec

    def resume(self) -> Set[int]:
        """Verify every journaled spill against its hash and return the
        committed set. A missing or corrupt spill drops its record (the
        partition runs again): never trusted."""
        with self._lock:
            good: Set[int] = set()
            bad: List[int] = []
            for i in sorted(self._records):
                if self._read_spill(self._records[i]) is None:
                    bad.append(i)
                else:
                    good.add(i)
            for i in bad:
                del self._records[i]
            if bad:
                self._rewrite_journal_locked()
        if good:
            health.record(health.DURABLE_RESUMED, job=self.job_id,
                          committed=len(good))
            logger.warning(
                "durable job %s: resuming with %d/%d partition(s) already "
                "committed", self.job_id, len(good), self._num_partitions)
        return good

    def _read_spill(self, rec: Dict[str, Any]) -> Optional[bytes]:
        path = os.path.join(self.dir, rec["spill"])
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError:
            return None
        if hashlib.sha256(payload).hexdigest() != rec["sha256"]:
            health.record(health.DURABLE_JOURNAL_TORN, job=self.job_id,
                          partition=rec["partition"])
            logger.warning(
                "durable job %s: spill %s failed content-hash verification; "
                "partition %d will recompute", self.job_id, rec["spill"],
                rec["partition"])
            return None
        return payload

    def load(self, index: int) -> Any:
        """One committed partition from its spill (verified at resume; a
        spill that vanishes mid-run is an I/O failure and raises)."""
        with self._lock:
            rec = self._records[index]
        payload = self._read_spill(rec)
        if payload is None:
            raise IOError(
                f"durable job {self.job_id}: spill for committed partition "
                f"{index} disappeared or corrupted after resume verification")
        health.record(health.DURABLE_PARTITION_RESTORED, partition=index,
                      quarantined=bool(rec.get("quarantined")))
        return decode_batch(payload)

    # -- the commit path -----------------------------------------------------

    def note_attempt(self, index: int) -> None:
        """Count one compute attempt (retries and hedges included)."""
        with self._lock:
            self._attempts[index] = self._attempts.get(index, 0) + 1

    def committed(self, index: int) -> bool:
        with self._lock:
            return index in self._records

    def records(self) -> List[Dict[str, Any]]:
        """The committed records, in partition order."""
        with self._lock:
            return [dict(self._records[i]) for i in sorted(self._records)]

    def commit(self, index: int, batch: Any,
               quarantined: bool = False) -> Any:
        """Spill and journal one finished partition; idempotent (a hedge
        that finishes after the winner committed is a no-op). The spill
        lands before the record that names it, so a crash between the two
        only recomputes the partition."""
        import time

        with self._lock:
            if index not in self._records:
                t0 = time.perf_counter()
                payload = encode_batch(batch)
                spill = f"part-{index:05d}.spill"
                # the commit lock serializes the publishes by design: two
                # interleaved tmp+replace cycles would lose records
                _atomic_write(os.path.join(self.dir, spill), payload)
                self._records[index] = {
                    "partition": index,
                    "attempts": self._attempts.get(index, 1),
                    "sha256": hashlib.sha256(payload).hexdigest(),
                    "spill": spill,
                    "quarantined": bool(quarantined),
                }
                self._rewrite_journal_locked()
                with _stats_lock:
                    _stats["spill_bytes"] += len(payload)
                    _stats["commit_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
        if resilience.should_fire("process_kill", partition=index):
            logger.warning(
                "FaultInjector: process_kill firing after commit of "
                "partition %d — SIGKILL self", index)
            os.kill(os.getpid(), signal.SIGKILL)
        return batch

    def _rewrite_journal_locked(self) -> None:
        import time

        t0 = time.perf_counter()
        payload = "".join(
            _record_line(self._records[i]) for i in sorted(self._records))
        _atomic_write(self._path, payload.encode())
        with _stats_lock:
            _stats["rewrite_ms"].append((time.perf_counter() - t0) * 1e3)


def maybe_journal(partitions: Sequence[Any], columns: Optional[Sequence[str]],
                  ops: Sequence[Any]) -> Optional[PartitionJournal]:
    """The job's journal when ``EngineConfig.durable_dir`` is set and the
    frame computes something; None otherwise (durability is opt-in)."""
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    root = EngineConfig.durable_dir
    if not root or not ops:
        return None
    return PartitionJournal(root, job_id(partitions, columns, ops),
                            len(partitions))


# ---------------------------------------------------------------------------
# Run-id pinning
# ---------------------------------------------------------------------------

def pinned_run_id(durable_dir: str, name: str = "sparkdl") -> str:
    """The durable run id under ``durable_dir``: the first caller mints
    and publishes it (``os.link`` is exclusive: one winner among racing
    restarts), every later process reads the same id. Telemetry pinned
    to it (``Telemetry(run_id=...)``) keeps one run identity across
    crashes."""
    os.makedirs(durable_dir, exist_ok=True)
    path = os.path.join(durable_dir, _RUN_ID_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().strip()
    except FileNotFoundError:
        pass
    minted = f"{name}-durable-{os.urandom(4).hex()}"
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(minted + "\n")
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, path)  # exclusive publish: fails iff another won
    except FileExistsError:
        pass
    finally:
        os.unlink(tmp)
    _fsync_dir(durable_dir)
    with open(path, encoding="utf-8") as f:
        return f.read().strip()
