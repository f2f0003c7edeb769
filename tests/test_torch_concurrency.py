"""The port's launch accounting and model state under many threads.

Partitions run on a pool of threads, so the launch counters, a capture's
record of its own launches, the device gate and a model's memoized
variants must hold when 8 threads use 2 programs at once. There is no
card here, so the kernel wrappers are stood in for by
``kernels._count_launch``, the one call through which every wrapper
counts a launch; the card test of the same (``test_torch_cuda.py::
test_threads_replay_two_programs_with_exact_launches``) captures real
graphs. Every wait here is bounded.
"""

import threading

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec

THREADS = 8
CALLS = 25
JOIN_S = 30.0

# two programs: the kernels one forward of each launches, by body
PROGRAMS = {
    "xception": [("sep2d", "wgmma")] * 34,
    "resized": [("preproc_resize", None)],
}


def _forward(name):
    for kernel, body in PROGRAMS[name]:
        kernels._count_launch(kernel, body)


def _capture(name):
    """What ``Compiled._capture`` does with the launches: record the
    forward's own launches on this thread, count none."""
    with kernels.recording_launches() as record:
        _forward(name)
    return record


def _run_threads(target, n=THREADS):
    errors = []

    def run(i):
        try:
            target(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a thread did not finish in time"
    assert not errors, errors


@pytest.fixture
def counters():
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def test_threads_capture_and_replay_two_programs_exactly(counters):
    """8 threads × 2 programs: each thread captures its program while the
    others replay theirs, then replays it CALLS times. Every capture's
    record equals a single-threaded capture's, and the counters end at
    exactly replays × launches per forward."""
    alone = {name: _capture(name) for name in PROGRAMS}
    assert kernels.launch_counts()["launches"] == \
        {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}
    records = [None] * THREADS
    barrier = threading.Barrier(THREADS, timeout=JOIN_S)

    def work(i):
        name = list(PROGRAMS)[i % 2]
        barrier.wait()
        records[i] = _capture(name)
        for _ in range(CALLS):
            kernels.add_launches(records[i])
            _forward(name)  # an eager forward among the replays

    _run_threads(work)
    for i, record in enumerate(records):
        assert record == alone[list(PROGRAMS)[i % 2]]
    per_thread = 2 * CALLS  # each call: one replay, one eager forward
    half = THREADS // 2
    assert kernels.launches == {"sep2d": 34 * per_thread * half,
                                "pw1x1": 0,
                                "preproc_resize": per_thread * half}
    assert kernels.launches_by_body["sep2d"] == {
        "wgmma": 34 * per_thread * half, "simt_f32": 0, "simt_bf16": 0}


def test_a_capture_books_none_of_another_threads_launches(counters):
    """A capture open on one thread while another thread launches: the
    graph's record holds its own launches only, the process counters the
    other thread's only."""
    opened, other_done = threading.Event(), threading.Event()
    record = {}

    def capture():
        with kernels.recording_launches() as rec:
            opened.set()
            assert other_done.wait(JOIN_S)
            kernels._count_launch("preproc_resize")
        record.update(rec)

    t = threading.Thread(target=capture)
    t.start()
    assert opened.wait(JOIN_S)
    for _ in range(7):
        kernels._count_launch("sep2d", "simt_f32")
    other_done.set()
    t.join(JOIN_S)
    assert not t.is_alive()
    assert record["launches"] == {"sep2d": 0, "pw1x1": 0,
                                  "preproc_resize": 1}
    assert kernels.launches == {"sep2d": 7, "pw1x1": 0, "preproc_resize": 0}


def test_device_gate_excludes_replays_from_a_capture():
    """While one thread holds the gate exclusively (a capture or an
    audition), no shared holder (a replay) runs; shared holders run
    together; the owner may re-enter and replay."""
    gate = kernels._DeviceGate()
    inside = {"shared": 0, "max_shared": 0, "shared_during_exclusive": 0}
    lock = threading.Lock()
    exclusive_on = threading.Event()

    def replay(_):
        for _ in range(50):
            with gate.shared():
                with lock:
                    inside["shared"] += 1
                    inside["max_shared"] = max(inside["max_shared"],
                                               inside["shared"])
                    if exclusive_on.is_set():
                        inside["shared_during_exclusive"] += 1
                with lock:
                    inside["shared"] -= 1

    def capture(_):
        for _ in range(20):
            with gate.exclusive():
                exclusive_on.set()
                with gate.exclusive(), gate.shared():  # audition, replay
                    pass
                exclusive_on.clear()

    def work(i):
        (capture if i == 0 else replay)(i)

    _run_threads(work)
    assert inside["shared_during_exclusive"] == 0
    assert inside["shared"] == 0


def _model(name="m"):
    return ModelFunction(lambda vs, x: vs(x), torch.nn.Linear(4, 3),
                         TensorSpec((None, 6, 5, 4)), name=name)


def test_memoized_variants_are_built_once_across_threads():
    """Every thread gets the same flattened, precision and resized
    variant and the same program: one model never holds two programs
    (two coalescing queues) for one function."""
    mf = _model()
    got = [None] * THREADS
    barrier = threading.Barrier(THREADS, timeout=JOIN_S)

    def work(i):
        barrier.wait()
        flat = mf.flattened()
        bf16 = flat.with_dtype("bfloat16")
        res = flat.resized((12, 10))
        got[i] = (flat, bf16, res, res.jitted("cpu"))

    _run_threads(work)
    for i in range(1, THREADS):
        for a, b in zip(got[0], got[i]):
            assert a is b


def test_first_move_of_a_model_happens_once():
    """8 threads making the first call on one model: its weights move
    once, and every thread finds them moved."""
    moves = []

    class Counted(torch.nn.Linear):
        def _apply(self, fn, *args, **kwargs):
            moves.append(threading.get_ident())
            return super()._apply(fn, *args, **kwargs)

    mf = ModelFunction(lambda vs, x: vs(x), Counted(4, 3),
                       TensorSpec((None, 4)))
    barrier = threading.Barrier(THREADS, timeout=JOIN_S)

    def work(_):
        barrier.wait()
        mf.to("meta")

    _run_threads(work)
    assert len(moves) == 1
    assert mf.variables.weight.device.type == "meta"


def test_a_move_completes_while_a_capture_holds_its_program():
    """A capture holds its program's lock and then takes
    ``kernels.weights_lock``; a move of the same weights holds
    ``weights_lock`` and drops the program's graphs. The move must not
    wait for the program's lock, or the two threads deadlock: here one
    thread holds the program's lock, as a capture does, until the move
    has finished, then takes ``weights_lock``."""
    mf = ModelFunction(lambda vs, x: vs(x), torch.nn.Linear(4, 3),
                       TensorSpec((None, 4)))
    program = mf.jitted("cpu")
    program._graphs[("stale",)] = object()
    holding, moved = threading.Event(), threading.Event()

    def work(i):
        if i == 0:  # the capture
            with program._lock:
                holding.set()
                assert moved.wait(JOIN_S), "the move waited for the capture"
                with kernels.weights_lock:
                    pass
        else:  # the move
            assert holding.wait(JOIN_S)
            mf.to("meta")
            moved.set()

    _run_threads(work, n=2)
    assert program.graphs == {}
    assert mf.variables.weight.device.type == "meta"


def test_threads_apply_two_programs_on_the_cpu_as_one_thread_does():
    """The same 2 programs applied from 8 threads at once give each
    thread the single-threaded outputs bit for bit."""
    models = [_model("a"), _model("b")]
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(5, 6, 5, 4)).astype(np.float32)
          for _ in range(THREADS)]
    alone = [models[i % 2].flattened().apply_batch(x, batch_size=4,
                                                   device="cpu")
             for i, x in enumerate(xs)]
    got = [None] * THREADS

    def work(i):
        got[i] = models[i % 2].flattened().apply_batch(
            xs[i], batch_size=4, device="cpu")

    _run_threads(work)
    for a, b in zip(alone, got):
        np.testing.assert_array_equal(a, b)
