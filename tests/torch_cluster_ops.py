"""Op factories the cluster tests ship to worker processes.

They live here, in a module that imports neither JAX nor the JAX
package, because a worker imports the module of every function it is
sent (``cluster/transport.py``): a test module would drag JAX into each
worker.
"""

import time

import numpy as np
import torch

from sparkdl_tpu_torch.core import health, resilience, telemetry
from sparkdl_tpu_torch.engine.dataframe import DataFrame


def frame(n=24, parts=4):
    return DataFrame.fromColumns({"x": np.arange(n, dtype=np.int64)},
                                 numPartitions=parts)


def probe(seed=5):
    """A column computed with a captured torch weight, recording one
    worker-side health event per partition."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(1, 3)).astype(np.float32))

    def op(batch):
        health.record("cluster_probe")
        x = torch.from_numpy(
            batch.column("x").astype(np.float32).reshape(-1, 1))
        return torch.tanh(x @ w).sum(dim=1).double().numpy()

    return op


def plus_one_logged(trace_path, delay_s=0.0):
    """x + 1, appending the partition's first x to ``trace_path`` (one
    line per execution, wherever it runs), after ``delay_s``."""
    def op(batch):
        time.sleep(delay_s)
        with open(trace_path, "a") as f:
            f.write(f"{int(batch.column('x')[0])}\n")
        return batch.column("x") + 1

    return op


def flaky(marker_path, kind):
    """Partition 0 fails: once, RETRYABLE (``retryable``), or always,
    FATAL (``fatal``)."""
    import os

    def op(batch):
        first = int(batch.column("x")[0]) if batch.num_rows else -1
        if kind == "retryable" and first == 0 \
                and not os.path.exists(marker_path):
            with open(marker_path, "w") as f:
                f.write("x")
            raise resilience.WorkerFault(
                "injected worker-side retryable loss")
        if kind == "fatal" and first == 0:
            raise ValueError("deliberately malformed partition")
        return batch.column("x") + 1

    return op


def sleeping(seconds):
    def op(batch):
        time.sleep(seconds)
        return batch

    return op


def slow_times3(batch):
    time.sleep(0.08)  # outlives the frame cadence: every worker ships
    return batch.column("x").astype(np.float64) * 3.0


def aggregate_breach(batch):
    """Each worker observes a queue-wait profile whose own p99 stays
    under 1.0 s; only the cluster-merged buckets breach. The tail comes
    last, so a partial frame never breaches early."""
    tel = telemetry.active()
    wid = int(tel.process_scope[1:]) if tel and tel.process_scope else 0
    vals = ([0.2] * 99 + [1.3]) if wid == 0 else ([0.2] * 98 + [0.9, 0.9])
    ctx = telemetry.current_context()
    for v in vals:
        telemetry.observe(telemetry.M_QUEUE_WAIT_S, v, exemplar=ctx)
    return batch.column("x").astype(np.float64) * 2.0
