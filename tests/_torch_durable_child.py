"""One killed leg of the durable kill -9 tests (tests/test_torch_durability.py).

Usage: python _torch_durable_child.py <port|jax> <materialize|stream>
       <work_dir> <kill_after>

Builds TestNet's featurizer in the named package from
``<work>/weights.npz`` (the flattened variables) over the images in
``<work>/images.npy``, in ``<work>/partitions`` partitions, on one
partition thread (so the commits come in partition order), with
``durable_dir = <work>/journal_<package>``, arms ``process_kill`` to
fire after the commit numbered ``kill_after`` (0-based) and runs the
job. The process must die by SIGKILL; exit code 3 says it did not.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_variables(path):
    import numpy as np

    tree = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def port_job(work, images, variables, parts):
    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
    from sparkdl_tpu_torch.image import imageIO

    s.EngineConfig.device = "cpu"
    s.EngineConfig.inference_precision = "float32"
    s.EngineConfig.max_workers = 1
    s.EngineConfig.durable_dir = os.path.join(work, "journal_port")
    df = s.DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(
            list(images), [f"img{i}" for i in range(len(images))])},
        numPartitions=parts)
    feat = s.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                 modelName="TestNet", weights=variables,
                                 batchSize=8)
    return feat.transform(df), Fault, FaultInjector


def jax_job(work, images, variables, parts):
    import pyarrow as pa

    import sparkdl_tpu as s
    from sparkdl_tpu.core.resilience import Fault, FaultInjector
    from sparkdl_tpu.engine.dataframe import EngineConfig
    from sparkdl_tpu.image import imageIO

    EngineConfig.max_workers = 1
    EngineConfig.inference_precision = "float32"  # as tests/conftest.py
    EngineConfig.bucket_ladder = "pow2"
    EngineConfig.durable_dir = os.path.join(work, "journal_jax")
    df = s.DataFrame.fromArrow(pa.table(
        {"image": imageIO.imageArraysToStructColumn(
            list(images), [f"img{i}" for i in range(len(images))])}),
        numPartitions=parts)
    feat = s.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                 modelName="TestNet", weights=variables,
                                 batchSize=8)
    return feat.transform(df), Fault, FaultInjector


def main():
    package, mode, work, kill_after = sys.argv[1:5]
    import numpy as np

    images = np.load(os.path.join(work, "images.npy"))
    variables = load_variables(os.path.join(work, "weights.npz"))
    with open(os.path.join(work, "partitions")) as f:
        parts = int(f.read())
    build = port_job if package == "port" else jax_job
    out, Fault, FaultInjector = build(work, images, variables, parts)
    with FaultInjector.seeded(0, process_kill=Fault(times=1,
                                                    after=int(kill_after))):
        if mode == "stream":
            for _ in out.streamPartitions():
                pass
        else:
            out.collect()
    sys.exit(3)  # process_kill should have fired


if __name__ == "__main__":
    main()
