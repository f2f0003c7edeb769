"""The port's multi-process decode pool (``core/decode_pool.py``): order,
crash respawn and the classified retry, typed worker errors, parity with
the inline path (and with the JAX package's ``readImages``), clean
shutdown, the orphan sweep, adopted worker spans, ``decode_workers=0``
making no pool, and workers that never import torch.

One two-worker pool serves the module (``EngineConfig.decode_workers =
2``, the process-wide pool); tests that must close a pool build a
one- or two-worker pool of their own and close it in ``finally``. Every
wait has a timeout.
"""

import io
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu_torch.core import decode_pool, health, resilience, telemetry
from sparkdl_tpu_torch.core.decode_pool import DecodePool
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
from sparkdl_tpu_torch.core.telemetry import Telemetry
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pool():
    """The process-wide pool of ``decode_workers = 2``; a test that
    decodes through it by the config sets that knob itself."""
    saved = EngineConfig.snapshot()
    EngineConfig.decode_workers = 2
    try:
        shared = decode_pool.maybe_pool()
    finally:
        EngineConfig.restore(saved)
    try:
        yield shared
    finally:
        decode_pool.shutdown()


@pytest.fixture(autouse=True)
def _restore_engine_config():
    saved = EngineConfig.snapshot()
    yield
    EngineConfig.restore(saved)


def _jpeg(rng, h=16, w=16):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _blobs(n=24, corrupt=(), none=()):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        if i in none:
            out.append(None)
        elif i in corrupt:
            out.append(b"definitely not an image")
        else:
            # sizes vary, so decode times are unequal and chunks finish
            # out of order across the workers
            out.append(_jpeg(rng, h=8 + 8 * (i % 7), w=8 + 4 * (i % 5)))
    return out


def _equal_rows(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        else:
            np.testing.assert_array_equal(a, b)


def _own_segments():
    """This process's decode-pool shared-memory segments."""
    if not os.path.isdir(decode_pool._SHM_DIR):
        return set()
    return {n for n in os.listdir(decode_pool._SHM_DIR)
            if n.startswith(f"{decode_pool._SHM_PREFIX}_{os.getpid():x}_")}


def test_order_preserved_under_unequal_decode_times(pool):
    """Every output index holds ITS blob's pixels, though blob sizes (and
    so decode times) vary and two workers race."""
    blobs = _blobs(40)
    inline = imageIO._decodeValidBlobs(blobs, (12, 12), 3)
    for _ in range(3):
        _equal_rows(pool.decode(blobs, target_size=(12, 12), channels=3),
                    inline)


def test_flexible_decode_preserves_source_geometry(pool):
    """No target size and no channels (the readImages default decoder):
    each blob keeps its own H×W, as the inline decoder gives it."""
    blobs = _blobs(10)
    got = pool.decode(blobs)
    _equal_rows(got, [imageIO.decodePoolBlob(b) for b in blobs])
    assert len({a.shape for a in got}) > 1


def test_worker_crash_respawns_and_recovers(pool):
    """One injected worker crash: the worker is respawned, exactly the
    lost chunk is dispatched again, the result is whole, and one
    decode_pool_respawn event is recorded."""
    blobs = _blobs(12)
    baseline = pool.decode(blobs, target_size=(8, 8), channels=3)
    respawns = pool.respawns
    with FaultInjector.seeded(0, decode_pool_worker_crash=1) as inj, \
            HealthMonitor() as mon:
        got = pool.decode(blobs, target_size=(8, 8), channels=3)
    assert inj.fired["decode_pool_worker_crash"] == 1
    assert mon.count(health.DECODE_POOL_RESPAWN) == 1
    assert pool.respawns == respawns + 1
    _equal_rows(got, baseline)
    assert all(w.proc.is_alive() for w in pool._workers)
    _equal_rows(pool.decode(blobs, target_size=(8, 8), channels=3),
                baseline)


def test_worker_crash_exhaustion_is_classified_retryable(pool):
    """A worker that crashes on every try spends the chunk's budget:
    DecodeWorkerLost, classified RETRYABLE (the engine's task retry owns
    the replay); the pool serves again afterwards."""
    blobs = _blobs(2)
    baseline = pool.decode(blobs, target_size=(8, 8), channels=3)
    with FaultInjector.seeded(0, decode_pool_worker_crash=Fault(times=-1)):
        with pytest.raises(resilience.DecodeWorkerLost) as ei:
            pool.decode(blobs, target_size=(8, 8), channels=3)
    assert resilience.classify(ei.value) == resilience.RETRYABLE
    _equal_rows(pool.decode(blobs, target_size=(8, 8), channels=3),
                baseline)


def test_worker_side_error_propagates_typed_like_inline(pool):
    """What the inline decoder raises (an unsupported channel count) is
    raised at the submitting call with its builtin type: FATAL, never a
    null row."""
    blobs = _blobs(4)
    with pytest.raises(ValueError):
        imageIO.decodePoolBlob(blobs[0], channels=2)
    with pytest.raises(ValueError) as ei:
        pool.decode(blobs, channels=2)
    assert resilience.classify(ei.value) == resilience.FATAL
    assert len(pool.decode(blobs, channels=3)) == 4


def test_tolerant_corrupt_blob_parity_pool_on_off(pool):
    """decodeImageBytesBatch through the pool and inline: the same rows
    (corrupt blobs the same Nones) and the same decode_degraded counts,
    recorded by the submitting process."""
    blobs = _blobs(18, corrupt={3, 11}, none={7})
    EngineConfig.decode_workers = 2
    with HealthMonitor() as mon_on:
        on = imageIO.decodeImageBytesBatch(blobs, (10, 10))
    EngineConfig.decode_workers = 0
    with HealthMonitor() as mon_off:
        off = imageIO.decodeImageBytesBatch(blobs, (10, 10))
    assert mon_on.count(health.DECODE_DEGRADED) \
        == mon_off.count(health.DECODE_DEGRADED) == 2
    _equal_rows(on, off)
    assert on[3] is None and on[11] is None and on[7] is None


def test_injected_decode_error_parity_pool_on_off(pool):
    """decode_error fires in the SUBMITTING process on both paths: the
    same degraded row, the same one injected decode_degraded event."""
    blobs = _blobs(6)

    def run(workers):
        EngineConfig.decode_workers = workers
        with FaultInjector.seeded(0, decode_error=1) as inj, \
                HealthMonitor() as mon:
            out = imageIO.decodeImageBytesBatch(blobs, (8, 8))
        assert inj.fired["decode_error"] == 1
        return out, mon.count(health.DECODE_DEGRADED)

    on, degraded_on = run(2)
    off, degraded_off = run(0)
    assert degraded_on == degraded_off == 1
    assert on[0] is None and off[0] is None
    _equal_rows(on[1:], off[1:])


def test_close_midstream_leaks_no_processes_or_segments():
    """close() while decodes are in flight: the waiter fails with a
    RETRYABLE DecodeWorkerLost (never hangs), every worker is joined and
    no shared-memory segment of this process survives."""
    blobs = _blobs(64, corrupt={5})
    own = DecodePool(workers=2)
    errors, calls = [], []
    done = threading.Event()

    def hammer():
        try:
            while not done.is_set():
                own.decode(blobs, target_size=(32, 32), channels=3)
                calls.append(1)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=hammer, name="test-decode-hammer")
    t.start()
    try:
        deadline = time.monotonic() + 30.0
        while not calls and not done.is_set() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)  # a decode is in flight now
    finally:
        own.close()
        done.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert calls, "no decode finished before close"
    if errors:
        assert isinstance(errors[0], resilience.DecodeWorkerLost)
        assert resilience.classify(errors[0]) == resilience.RETRYABLE
    assert all(not w.proc.is_alive() for w in own._workers)
    assert own._pending == {}
    own.close()  # idempotent
    assert not _own_segments()


def test_workers_zero_is_inline_and_poolless():
    """The default decodes inline: no pool is built."""
    assert EngineConfig.decode_workers == 0
    assert decode_pool.maybe_pool() is None
    blobs = _blobs(8, corrupt={2})
    out = imageIO.decodeImageBytesBatch(blobs, (8, 8))
    _equal_rows(out, imageIO._decodeValidBlobs(blobs, (8, 8), 3))
    assert out[2] is None


def test_read_images_pool_parity_and_telemetry(pool, tmp_path):
    """readImages end to end: the pool on, the pool off and the JAX
    package's reader give the same rows (a corrupt file's null struct
    included) and the same decode_degraded counts, and the pool's span,
    gauges and decode-time histogram land in the telemetry scope, the
    span under the partition task that submitted it."""
    rng = np.random.default_rng(1)
    for i in range(9):
        Image.fromarray(rng.integers(0, 255, (12 + i, 14, 3),
                                     dtype=np.uint8)
                        ).save(tmp_path / f"img_{i}.png")
    (tmp_path / "bad.jpg").write_bytes(b"corrupt")
    with jax_health.HealthMonitor() as jmon:
        ref = jax_imageIO.readImages(str(tmp_path), numPartition=3).collect()
    EngineConfig.decode_workers = 2
    with HealthMonitor() as mon_on, Telemetry("decode-pool-test") as tel:
        rows_on = imageIO.readImages(str(tmp_path), numPartition=3).collect()
    EngineConfig.decode_workers = 0
    with HealthMonitor() as mon_off:
        rows_off = imageIO.readImages(str(tmp_path),
                                      numPartition=3).collect()
    assert rows_on == rows_off == ref
    assert mon_on.count(health.DECODE_DEGRADED) \
        == mon_off.count(health.DECODE_DEGRADED) \
        == jmon.count(jax_health.DECODE_DEGRADED) == 1
    snap = tel.metrics.snapshot()
    assert snap["histograms"][telemetry.M_DECODE_POOL_DECODE_S]["count"] > 0
    assert telemetry.M_DECODE_POOL_DEPTH in snap["gauges"]
    assert telemetry.M_DECODE_POOL_BUSY in snap["gauges"]
    spans = tel.tracer.spans(telemetry.SPAN_DECODE_POOL)
    assert len(spans) == 3
    by_id = {s["span_id"]: s for s in tel.tracer.spans()}
    for span in spans:  # up the parents to the partition's task span
        while span["name"] != telemetry.SPAN_TASK:
            span = by_id[span["parent_id"]]


def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=60)
    return proc.pid


def _segment(owner_pid, seq):
    """A segment named as a worker of ``owner_pid`` names its own,
    handed to the file system (this process's tracker forgets it)."""
    from multiprocessing import resource_tracker, shared_memory

    seg = shared_memory.SharedMemory(
        name=f"{decode_pool._SHM_PREFIX}_{owner_pid:x}_{owner_pid:x}"
             f"_{seq:x}", create=True, size=64)
    resource_tracker.unregister(seg._name, "shared_memory")
    seg.close()
    return seg.name


def test_sweep_reclaims_dead_owner_segments_only():
    """A killed owner's segments (the name holds the owner's pid) are
    reclaimed; a live owner's are left alone."""
    if not os.path.isdir(decode_pool._SHM_DIR):
        pytest.skip("no /dev/shm on this platform")
    dead_name = _segment(_dead_pid(), 1)
    live_name = _segment(os.getpid(), 2)
    try:
        with HealthMonitor() as mon:
            swept = decode_pool.sweep_orphaned_segments()
        assert swept >= 1
        listing = set(os.listdir(decode_pool._SHM_DIR))
        assert dead_name not in listing and live_name in listing
        assert mon.count(health.DECODE_POOL_SHM_SWEPT) >= 1
    finally:
        for name in (dead_name, live_name):
            try:
                os.unlink(os.path.join(decode_pool._SHM_DIR, name))
            except OSError:
                pass


def test_pool_startup_runs_orphan_sweep():
    """DecodePool() sweeps before it spawns: a killed run's segments are
    reclaimed by the next pool with no operator action."""
    if not os.path.isdir(decode_pool._SHM_DIR):
        pytest.skip("no /dev/shm on this platform")
    name = _segment(_dead_pid(), 9)
    own = DecodePool(workers=1)
    try:
        assert name not in set(os.listdir(decode_pool._SHM_DIR))
    finally:
        own.close()


def test_decode_chunk_spans_adopt_under_the_pool_span(pool):
    """Inside a telemetry scope each chunk comes back with a
    ``sparkdl.decode_chunk`` span measured IN its worker (the worker's
    pid kept) and adopted under the ``sparkdl.decode_pool`` span."""
    blobs = _blobs(12)
    with Telemetry("decode-trace") as tel:
        got = pool.decode(blobs, target_size=(8, 8), channels=3)
    assert len(got) == len(blobs)
    (pool_span,) = tel.tracer.spans(telemetry.SPAN_DECODE_POOL)
    chunks = tel.tracer.spans(telemetry.SPAN_DECODE_CHUNK)
    assert chunks
    for s in chunks:
        assert s["parent_id"] == pool_span["span_id"]
        assert s["trace_id"] == tel.tracer.trace_id
        assert s["pid"] != os.getpid()
        assert s["process"] == f"decode-{s['pid']}"
        # the worker's times come through the clock handshake's estimate,
        # off by up to half its round trip: only their order is exact
        assert s["end_ns"] >= s["start_ns"]
    assert sum(s["attributes"]["blobs"] for s in chunks) == len(blobs)
    assert tel.tracer.summary()["remote_adopted"] == len(chunks)
    pids = {e["pid"] for e in tel.tracer.chrome_trace()["traceEvents"]}
    assert {s["pid"] for s in chunks} < pids


def test_decode_without_scope_ships_no_spans(pool):
    """With no telemetry scope the tasks carry no context, the workers
    build no span records and a later scope adopts nothing."""
    pool.decode(_blobs(6), target_size=(8, 8), channels=3)
    with Telemetry("later") as tel:
        pass
    assert tel.tracer.spans(telemetry.SPAN_DECODE_CHUNK) == []
    assert tel.tracer.summary()["remote_adopted"] == 0


def test_remote_spans_adopt_and_refuse_as_the_reference():
    """``remote_span``, ``Tracer.record_remote`` and
    ``adopt_remote_spans`` take canonical names in and count the others
    refused, as the JAX package's do; ``remote_span`` raises for a name
    a parent would refuse."""
    from sparkdl_tpu.core import telemetry as jax_telemetry

    results = []
    for mod in (telemetry, jax_telemetry):
        with mod.Telemetry("remote") as tel:
            now = time.perf_counter_ns()
            wire = mod.remote_span(mod.SPAN_DECODE_CHUNK, now, now + 10,
                                   pid=7, blobs=2)
            shipped = [dict(wire, trace_id=tel.tracer.trace_id, span_id=5,
                            parent_id=None, thread_id=0, thread_name="w"),
                       dict(wire, name="sparkdl.not_canonical")]
            adopted = tel.tracer.adopt_remote_spans(shipped)
            kept = tel.tracer.record_remote(
                mod.SPAN_DECODE_CHUNK, None, now, now + 20, pid=7,
                process="decode-7", blobs=3)
            refused = tel.tracer.record_remote(
                "sparkdl.not_canonical", None, now, now, pid=7)
        summary = tel.tracer.summary()
        spans = tel.tracer.spans(mod.SPAN_DECODE_CHUNK)
        results.append((wire["attributes"], adopted, kept, refused,
                        summary["remote_adopted"], summary["remote_rejected"],
                        sorted(s["end_ns"] - s["start_ns"] for s in spans)))
        with pytest.raises(ValueError):
            mod.remote_span("sparkdl.not_canonical", 0, 1)
    assert results[0] == results[1]
    assert results[0][1:6] == ((1, 1), True, False, 2, 2)


def test_clock_handshake_offsets_onto_the_parent_clock():
    """One round trip against an answering parent gives the offset of
    this process's clock (here the same clock: within the round trip of
    0); with no answer the handshake gives 0."""
    import multiprocessing

    parent, child = multiprocessing.Pipe()

    def answer():
        parent.recv()
        parent.send(time.perf_counter_ns())

    t = threading.Thread(target=answer, name="test-clock-answer")
    t.start()
    t0 = time.perf_counter_ns()
    offset = telemetry.clock_handshake(child)
    rtt = time.perf_counter_ns() - t0
    t.join(timeout=10.0)
    assert not t.is_alive() and abs(offset) <= rtt
    silent, other = multiprocessing.Pipe()
    assert telemetry.clock_handshake(other, timeout_s=0.05) == 0
    for conn in (parent, child, silent, other):
        conn.close()


def test_workers_never_import_torch(tmp_path):
    """A process that imports what a decode worker imports has no torch
    in ``sys.modules``, and a real pool's workers map no libtorch while
    they decode."""
    script = tmp_path / "workers.py"
    script.write_text(
        "import io, sys\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "from sparkdl_tpu_torch.core import decode_pool\n"
        "from sparkdl_tpu_torch.image import imageIO\n"
        "from sparkdl_tpu_torch.native import loader\n"
        "if __name__ == '__main__':\n"
        "    loader.available()\n"
        "    print('torch' in sys.modules)\n"
        "    buf = io.BytesIO()\n"
        "    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(\n"
        "        buf, format='PNG')\n"
        "    with decode_pool.DecodePool(workers=1) as pool:\n"
        "        out = pool.decode([buf.getvalue()] * 2, (4, 4), 3)\n"
        "        assert out[0].shape == (4, 4, 3)\n"
        "        pid = pool._workers[0].proc.pid\n"
        "        maps = open(f'/proc/{pid}/maps').read()\n"
        "    print('libtorch' in maps)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["False", "False"]


def test_maybe_pool_lifecycle_follows_the_knobs(pool):
    """maybe_pool keeps one process-wide pool per setting of the knobs,
    builds a new one (closing the old) when they change, and validates
    them. Runs last in this module: it closes the module's pool."""
    EngineConfig.decode_workers = 2
    assert decode_pool.maybe_pool() is pool and pool.workers == 2
    EngineConfig.decode_pool_inflight = 3
    pool2 = decode_pool.maybe_pool()
    assert pool2 is not pool and pool.closed
    assert pool2.workers == 2 and pool2.inflight == 3
    decode_pool.shutdown()
    assert pool2.closed
    EngineConfig.decode_workers = -1
    with pytest.raises(ValueError, match="decode_workers"):
        decode_pool.maybe_pool()
    EngineConfig.decode_workers = 1
    EngineConfig.decode_pool_inflight = 0
    with pytest.raises(ValueError, match="decode_pool_inflight"):
        decode_pool.maybe_pool()
