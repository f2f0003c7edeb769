"""The cluster inference plane: one engine job across N worker processes.

The port of ``sparkdl_tpu.cluster``. The reference scaled inference out
through Spark's executors; here each worker is a spawned process with a
whole inference stack of its own, and on one card the workers share it.
Four modules:

- ``cluster/worker.py``: the spawned worker process (its own CUDA
  context, ``DeviceExecutor`` and captured graphs, and
  ``Telemetry(run_id=...)`` pinned to the coordinator's run id);
- ``cluster/router.py``: the load-aware partition router behind
  ``engine/dataframe.py``'s materialize and stream, routed THROUGH the
  supervisor so deadlines, classified retry, hedging and quarantine hold
  across the process boundary; precise re-dispatch when a worker dies;
  the autoscaler, the drain, metrics federation and the flight recorder;
- ``cluster/aggregate.py``: the merge of the workers' end-of-run
  snapshots into one ``cluster`` report section;
- ``cluster/transport.py``: the pickling of op chains and the boot
  snapshot (closures by value, tensors as CPU arrays).

Behind ``EngineConfig.cluster_workers`` (0, the default, keeps the
in-process path and never imports this package). No submodule is
imported here: the gate in ``engine/dataframe.py`` stays the only
importer, and a worker reaching ``cluster.worker`` does not load the
router. The reference's cluster serving plane (``serving/cluster.py``
and the worker's ``srv_*`` messages) is not ported yet.
"""

__all__ = ["aggregate", "router", "transport", "worker"]
