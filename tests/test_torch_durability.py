"""The port's durable job recovery (``core/durability.py``): job identity,
the write-ahead journal, the spill format, resume after kill -9, and
the featurize slice against the JAX package's durable materialize.

Each case of the JAX package's ``tests/core/test_durability.py`` has its
counterpart here over the port's frames. The kill -9 cases run a child
(``tests/_torch_durable_child.py``) that featurizes TestNet (float32, on
the CPU, one partition thread) with ``process_kill`` armed; it dies by
SIGKILL after its third commit, and this process resumes the same job:
the committed partitions load from their spills, only the others run,
and the rows equal an uninterrupted run's bit for bit. The JAX package
does the same in a child of its own; the two committed sets and resume
sets must be equal, and the rows within the float32 slice tolerance,
``1e-3·max|ref|``.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import sparkdl_tpu_torch
from sparkdl_tpu.engine.dataframe import EngineConfig as JaxEngineConfig
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.core import durability, health
from sparkdl_tpu_torch.core.durability import PartitionJournal
from sparkdl_tpu_torch.core.health import HealthMonitor
from sparkdl_tpu_torch.engine.dataframe import Batch, DataFrame, EngineConfig
from sparkdl_tpu_torch.image import imageIO
from tests._torch_durable_child import jax_job
from tests.torch_port_helpers import headless, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_durable_child.py")
F32_REL = 1e-3
N_IMAGES, PARTS, KILL_AFTER = 12, 6, 2


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    yield
    EngineConfig.restore(saved)


def make_df(n=12, parts=4):
    return DataFrame.fromColumns({"x": np.arange(n, dtype=np.int64)},
                                 numPartitions=parts)


def _batch(lo, hi):
    return Batch({"x": np.arange(lo, hi, dtype=np.int64)}, hi - lo)


def _same(a, b):
    return durability.encode_batch(a) == durability.encode_batch(b)


def _plan(df):
    return df._partitions, df.columns, df._ops


# -- job identity ------------------------------------------------------------

def test_job_id_stable_across_equal_plans():
    def build():
        return make_df().withColumn("y", lambda x: x + 1, ["x"])

    assert durability.job_id(*_plan(build())) \
        == durability.job_id(*_plan(build()))


def test_job_id_sensitive_to_ops_data_and_captured_state():
    df = make_df()
    base = df.withColumn("y", lambda x: x + 1, ["x"])
    ids = {durability.job_id(*_plan(f)) for f in (
        base,
        df.select("x"),                                     # another op
        base.select("y"),                                   # an extra op
        make_df(16, 4).withColumn("y", lambda x: x + 1, ["x"]),  # data
    )}
    assert len(ids) == 4
    # what a closure holds tells apart plans of one qualname
    assert durability.job_id(*_plan(df.select("x"))) \
        != durability.job_id(*_plan(df.select("x", "x")))


def test_stable_repr_reads_no_tensor_values_and_no_address():
    import torch

    t = torch.arange(6.0).reshape(2, 3)
    assert durability._stable_repr(t) == "Tensor(torch.float32,(2, 3),cpu)"
    assert durability._stable_repr(torch.nn.Linear(2, 3)) == "Linear"
    assert durability._stable_repr(object()) == "object"


def test_maybe_journal_opt_in_only(tmp_path):
    df = make_df().select("x")
    assert EngineConfig.durable_dir is None
    assert durability.maybe_journal(*_plan(df)) is None
    EngineConfig.durable_dir = str(tmp_path)
    assert durability.maybe_journal(*_plan(make_df())) is None  # no ops
    assert durability.maybe_journal(*_plan(df)) is not None


# -- journal mechanics -------------------------------------------------------

def test_commit_load_roundtrip_bit_identical(tmp_path):
    j = PartitionJournal(str(tmp_path), "job-a", 2)
    b0, b1 = _batch(0, 5), _batch(5, 9)
    j.commit(0, b0)
    j.commit(1, b1, quarantined=True)
    j2 = PartitionJournal(str(tmp_path), "job-a", 2)
    assert j2.resume() == {0, 1}
    assert _same(j2.load(0), b0) and _same(j2.load(1), b1)
    recs = j2.records()
    assert [r["partition"] for r in recs] == [0, 1]
    assert [r["quarantined"] for r in recs] == [False, True]


def test_commit_idempotent_and_attempts_counted(tmp_path):
    j = PartitionJournal(str(tmp_path), "job-b", 1)
    j.note_attempt(0)
    j.note_attempt(0)
    j.commit(0, _batch(0, 3))
    j.commit(0, _batch(100, 103))  # a hedge that lost: no-op
    assert _same(j.load(0), _batch(0, 3))
    assert j.records()[0]["attempts"] == 2


def test_commit_stats_count_each_commit_once(tmp_path):
    durability.reset_commit_stats()
    j = PartitionJournal(str(tmp_path), "job-s", 2)
    j.commit(0, _batch(0, 3))
    j.commit(0, _batch(0, 3))  # idempotent: no spill, no rewrite
    j.commit(1, _batch(3, 7))
    stats = durability.commit_stats()
    assert len(stats["commit_ms"]) == 2 and len(stats["rewrite_ms"]) == 2
    assert min(stats["commit_ms"]) > 0
    assert stats["spill_bytes"] == sum(
        os.path.getsize(os.path.join(j.dir, f"part-{i:05d}.spill"))
        for i in (0, 1))
    durability.reset_commit_stats()
    assert durability.commit_stats() == {"commit_ms": [], "rewrite_ms": [],
                                         "spill_bytes": 0}


def test_torn_journal_tail_discarded_never_trusted(tmp_path):
    j = PartitionJournal(str(tmp_path), "job-c", 2)
    j.commit(0, _batch(0, 4))
    j.commit(1, _batch(4, 8))
    path = os.path.join(str(tmp_path), "job-c", "journal.jsonl")
    lines = open(path).read().splitlines()
    with open(path, "w") as f:  # a crash mid-append tore the last record
        f.write(lines[0] + "\n" + lines[1][:len(lines[1]) // 2])
    with HealthMonitor() as mon:
        j2 = PartitionJournal(str(tmp_path), "job-c", 2)
        assert j2.resume() == {0}
    assert mon.events(health.DURABLE_JOURNAL_TORN)
    assert not j2.committed(1)


def test_tampered_record_body_fails_line_digest(tmp_path):
    j = PartitionJournal(str(tmp_path), "job-d", 1)
    j.commit(0, _batch(0, 4))
    path = os.path.join(str(tmp_path), "job-d", "journal.jsonl")
    obj = json.loads(open(path).read())
    obj["rec"]["attempts"] = 99
    with open(path, "w") as f:
        f.write(json.dumps(obj) + "\n")
    assert PartitionJournal(str(tmp_path), "job-d", 1).resume() == set()


def test_corrupt_spill_dropped_and_partition_recomputes(tmp_path):
    j = PartitionJournal(str(tmp_path), "job-e", 2)
    j.commit(0, _batch(0, 4))
    j.commit(1, _batch(4, 8))
    spill = os.path.join(str(tmp_path), "job-e", "part-00001.spill")
    raw = bytearray(open(spill, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(spill, "wb") as f:
        f.write(raw)
    with HealthMonitor() as mon:
        assert PartitionJournal(str(tmp_path), "job-e", 2).resume() == {0}
    assert mon.events(health.DURABLE_JOURNAL_TORN)
    # the dropped record is gone from the rewritten journal too
    assert PartitionJournal(str(tmp_path), "job-e", 2).resume() == {0}


# -- the spill format --------------------------------------------------------

def test_spill_format_round_trips_every_column_kind():
    import torch  # noqa: F401 - numpy only below; torch must not matter

    block = np.arange(2 * 3 * 2 * 3, dtype=np.uint8).reshape(2, 3, 2, 3)
    col_block = imageIO.ImageColumn(
        origin=["a", "b", "c"], height=[3, 0, 3], width=[2, 0, 2],
        nChannels=[3, 0, 3], mode=[16, -1, 16], valid=[True, False, True],
        block=block)
    col_data = imageIO.ImageColumn(
        origin=["d", "e", "f"], height=[1, 0, 2], width=[1, 0, 1],
        nChannels=[3, 0, 3], mode=[16, -1, 16], valid=[True, False, True],
        data=[b"\x01\x02\x03", None, bytes(6)])
    objs = np.empty(3, dtype=object)
    objs[:] = [np.float32(1.5), None, "s"]
    b = Batch({"f": np.linspace(0, 1, 3, dtype=np.float32),
               "m": np.arange(6, dtype=np.float64).reshape(3, 2)[:, ::-1],
               "vec": [np.ones(2, np.float32), None, np.zeros(2, np.float32)],
               "mixed": [(1, "x", np.int64(2)), {"k": [1.0, float("nan")]},
                         True],
               "obj": objs, "img": col_block, "raw": col_data}, 3)
    payload = durability.encode_batch(b)
    back = durability.decode_batch(payload)
    assert durability.encode_batch(back) == payload  # a fixed point
    assert list(back.columns) == list(b.columns) and back.num_rows == 3
    assert np.array_equal(back.column("m"), b.column("m"))
    assert back.column("m").flags.c_contiguous
    assert back.column("vec")[1] is None
    assert back.column("vec")[0].dtype == np.float32
    mixed = back.column("mixed")
    assert mixed[0] == (1, "x", 2) and type(mixed[0][2]) is np.int64
    assert mixed[1]["k"][0] == 1.0 and np.isnan(mixed[1]["k"][1])
    assert mixed[2] is True
    assert back.column("obj").dtype == object
    assert type(back.column("obj")[0]) is np.float32
    assert np.array_equal(back.column("img").block, block)
    assert back.column("img").to_pylist() == col_block.to_pylist()
    assert back.column("raw").to_pylist() == col_data.to_pylist()


def test_spill_format_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError, match="set"):
        durability.encode_batch(Batch({"s": [{1, 2}]}, 1))
    payload = bytearray(durability.encode_batch(_batch(0, 3)))
    payload[0] ^= 0xFF
    with pytest.raises(IOError, match="magic"):
        durability.decode_batch(bytes(payload))
    with pytest.raises(IOError, match="stray"):
        durability.decode_batch(durability.encode_batch(_batch(0, 3))
                                + b"x")


# -- engine integration ------------------------------------------------------

def _counting(calls, key=False):
    def op(batch):
        calls.append(int(batch.column("x")[0]) if key else len(
            batch.column("x")))
        return batch.column("x") + 1
    return op


def test_durable_materialize_resumes_zero_recompute(tmp_path):
    EngineConfig.durable_dir = str(tmp_path)
    calls = []
    want = make_df().withColumnBatch("y", _counting(calls)).collect()
    assert len(calls) == 4
    with HealthMonitor() as mon:
        got = make_df().withColumnBatch("y", _counting(calls)).collect()
    assert got == want and len(calls) == 4  # all served from spill
    assert mon.events(health.DURABLE_RESUMED)
    assert len(mon.events(health.DURABLE_PARTITION_RESTORED)) == 4


def test_durable_stream_resumes_in_original_order(tmp_path):
    EngineConfig.durable_dir = str(tmp_path)
    calls = []
    want = list(make_df().withColumnBatch(
        "y", _counting(calls)).streamPartitions())
    got = list(make_df().withColumnBatch(
        "y", _counting(calls)).streamPartitions(order=[0, 1, 2, 3]))
    assert len(calls) == 4 and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _same(g, w)


def test_durable_partial_run_resumes_only_missing(tmp_path):
    EngineConfig.durable_dir = str(tmp_path)
    df = make_df().withColumnBatch("y", _counting([], key=True))
    j = PartitionJournal(str(tmp_path), durability.job_id(*_plan(df)), 4)
    for i in (0, 2):  # a crashed first run committed 0 and 2
        out = df._partitions[i]
        for op in df._ops:
            out = op(out)
        j.commit(i, out)
    calls = []
    rows = make_df().withColumnBatch("y", _counting(calls, key=True)) \
        .collect()
    assert sorted(calls) == [3, 9]  # only partitions 1 and 3 ran
    assert [r["y"] for r in rows] == [i + 1 for i in range(12)]


def test_durable_dir_unset_identical_behavior(tmp_path):
    calls = []
    make_df().withColumnBatch("y", _counting(calls)).collect()
    make_df().withColumnBatch("y", _counting(calls)).collect()
    assert len(calls) == 8  # no journal, no resume: both runs compute
    assert os.listdir(tmp_path) == []


def test_durable_quarantine_verdict_commits(tmp_path):
    EngineConfig.durable_dir = str(tmp_path)
    EngineConfig.quarantine = True

    def build(calls):
        def op(batch):
            if batch.num_rows and int(batch.column("x")[0]) == 3:
                calls.append("poison")
                raise ValueError("poison partition")
            return batch.column("x") + 1
        return make_df().withColumnBatch("y", op)

    first = []
    rows = build(first).collect()
    assert first == ["poison"] and len(rows) == 9
    again = []
    with HealthMonitor() as mon:
        assert build(again).collect() == rows
    assert again == []  # the verdict came back from the journal
    restored = mon.events(health.DURABLE_PARTITION_RESTORED)
    assert sorted(e["quarantined"] for e in restored) == [
        False, False, False, True]


# -- run-id pinning ----------------------------------------------------------

def test_pinned_run_id_stable_across_processes(tmp_path):
    a = durability.pinned_run_id(str(tmp_path))
    b = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]);"
         "from sparkdl_tpu_torch.core import durability;"
         "print(durability.pinned_run_id(sys.argv[2]))", ROOT,
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        check=True).stdout.strip()
    assert a == b and a.startswith("sparkdl-durable-")


def test_pinned_run_id_respects_existing_winner(tmp_path):
    with open(tmp_path / "run_id", "w") as f:
        f.write("winner-1234\n")
    assert durability.pinned_run_id(str(tmp_path)) == "winner-1234"


# -- kill -9 -----------------------------------------------------------------

@pytest.fixture(scope="module")
def variables():
    return headless(random_variables(jax_testnet.TestNet(include_top=True),
                                     (1, 32, 32, 3), seed=71))


@pytest.fixture(scope="module")
def work(tmp_path_factory, variables):
    d = tmp_path_factory.mktemp("durable_kill")
    rng = np.random.default_rng(72)
    np.save(d / "images.npy",
            rng.integers(0, 256, size=(N_IMAGES, 40, 36, 3), dtype=np.uint8))
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk("", variables)
    np.savez(d / "weights.npz", **flat)
    (d / "partitions").write_text(str(PARTS))
    return d


def _kill(work, package, mode):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, CHILD, package, mode, str(work), str(KILL_AFTER)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]


def _journal(root):
    (job,) = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    return PartitionJournal(root, job, PARTS)


def _port_frame(work, variables):
    images = list(np.load(work / "images.npy"))
    feat = sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="TestNet",
        weights=variables, batchSize=8)
    df = DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(
            images, [f"img{i}" for i in range(len(images))])},
        numPartitions=PARTS)
    return feat.transform(df)


def _rows(batches):
    return np.concatenate([np.stack(b.column("features")) for b in batches])


@pytest.mark.parametrize("mode", ["materialize", "stream"])
def test_kill9_resume_is_bit_identical_with_zero_recompute(work, variables,
                                                           mode):
    EngineConfig.max_workers = 1
    want = _rows(_port_frame(work, variables)._materialize())
    _kill(work, "port", mode)
    root = str(work / "journal_port")
    committed = [r["partition"] for r in _journal(root).records()]
    assert committed == list(range(KILL_AFTER + 1))
    spills = {i: open(os.path.join(_journal(root).dir,
                                   f"part-{i:05d}.spill"), "rb").read()
              for i in committed}
    EngineConfig.durable_dir = root
    with HealthMonitor() as mon:
        out = _port_frame(work, variables)
        batches = (out._materialize() if mode == "materialize"
                   else list(out.streamPartitions()))
    got = _rows(batches)
    assert np.array_equal(got, want)
    assert mon.count(health.DURABLE_RESUMED) == 1
    assert mon.count(health.DURABLE_PARTITION_RESTORED) == len(committed)
    assert mon.count(health.TASK_STARTED) == PARTS - len(committed)
    # the restored partitions are the killed run's spills, bit for bit
    for i in committed:
        assert durability.encode_batch(batches[i]) == spills[i]
    # the job is whole now: a third run computes nothing
    with HealthMonitor() as mon:
        again = _rows(_port_frame(work, variables)._materialize())
    assert np.array_equal(again, want)
    assert mon.count(health.TASK_STARTED) == 0
    # the next leg starts from no journal
    import shutil
    shutil.rmtree(root)


def test_durable_slice_matches_reference_after_kill9(work, variables):
    """Both packages' durable featurize jobs killed after their third
    commit: the same committed set, the same resume set, and rows within
    the float32 slice tolerance of the reference's resumed run."""
    _kill(work, "port", "materialize")
    _kill(work, "jax", "materialize")
    port_root, jax_root = str(work / "journal_port"), str(work /
                                                            "journal_jax")
    committed = [r["partition"] for r in _journal(port_root).records()]
    with open(os.path.join(jax_root, [d for d in os.listdir(jax_root)][0],
                           "journal.jsonl")) as f:
        jax_committed = sorted(json.loads(line)["rec"]["partition"]
                               for line in f if line.strip())
    assert committed == jax_committed == list(range(KILL_AFTER + 1))

    EngineConfig.max_workers = 1
    EngineConfig.durable_dir = port_root
    with HealthMonitor() as mon:
        ours = _rows(_port_frame(work, variables)._materialize())
    port_resumed = sorted(e["partition"] for e in
                          mon.events(health.DURABLE_PARTITION_RESTORED))

    from sparkdl_tpu.core import health as jax_health

    images = np.load(work / "images.npy")
    saved = JaxEngineConfig.snapshot()
    try:
        # the frame and featurizer the killed child built, so the same
        # job id
        out, _, _ = jax_job(str(work), images, variables, PARTS)
        with jax_health.HealthMonitor() as jmon:
            ref = np.stack([np.asarray(r["features"], np.float32)
                            for r in out.collect()])
    finally:
        JaxEngineConfig.restore(saved)
    jax_resumed = sorted(e["partition"] for e in
                         jmon.events(jax_health.DURABLE_PARTITION_RESTORED))
    assert port_resumed == jax_resumed == committed
    assert ours.shape == ref.shape == (N_IMAGES, 16)
    assert float(np.max(np.abs(ours - ref))) <= F32_REL * np.abs(ref).max()
