"""The port stands alone: it imports nothing of JAX or of ``sparkdl_tpu``,
and it runs on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sparkdl_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_no_forbidden_imports_in_source():
    files = sorted((ROOT / "sparkdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    assert ROOT / "sparkdl_tpu_torch" / "experiments" / "probe.py" in files
    for ingest in ("core/decode_pool.py", "native/loader.py",
                   "native/__init__.py", "image/imageIO.py"):
        assert ROOT / "sparkdl_tpu_torch" / ingest in files
    for serving in ("serving/__init__.py", "serving/registry.py",
                    "serving/residency.py", "serving/server.py",
                    "serving/cluster.py", "core/slo.py",
                    "core/telemetry.py"):
        assert ROOT / "sparkdl_tpu_torch" / serving in files
    for flagship in ("engine/sql_expr.py", "udf/__init__.py",
                     "udf/registry.py", "ml/base.py", "ml/linear_utils.py",
                     "ml/lbfgs.py", "ml/classification.py",
                     "ml/evaluation.py", "ml/persistence.py"):
        assert ROOT / "sparkdl_tpu_torch" / flagship in files
    for cluster in ("core/durability.py", "cluster/__init__.py",
                    "cluster/worker.py", "cluster/router.py",
                    "cluster/aggregate.py", "cluster/transport.py"):
        assert ROOT / "sparkdl_tpu_torch" / cluster in files
    for train in ("train/__init__.py", "train/trainer.py",
                  "train/optimizers.py", "train/checkpoint.py",
                  "train/metrics.py", "core/debug.py"):
        assert ROOT / "sparkdl_tpu_torch" / train in files
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad.extend(f"{path.relative_to(ROOT)}: {n}" for n in names
                       if _forbidden(n))
    assert not bad, bad


def test_no_cloudpickle_or_pyarrow_in_the_port():
    """Nothing guarantees cloudpickle or pyarrow on the card's machine:
    the port (its cluster serving plane included) and chip_smoke.py
    import neither; loaders travel through ``cluster/transport.py`` and
    rows as plain pickles of numpy arrays."""
    files = sorted((ROOT / "sparkdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert ROOT / "sparkdl_tpu_torch" / "serving" / "cluster.py" in files
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad.extend(f"{path.relative_to(ROOT)}: {n}" for n in names
                       if n.split(".")[0] in ("cloudpickle", "pyarrow"))
    assert not bad, bad


def test_featurize_on_cpu_loads_no_jax(tmp_path):
    """Featurizing with each ported model on the CPU in a fresh process,
    over a frame of three partitions (so the partition pool, the
    supervisor and the coalescing executor run), leaves no JAX and no
    ``sparkdl_tpu`` in ``sys.modules``."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import sys, threading\n"
        "import numpy as np\n"
        "import sparkdl_tpu_torch as s\n"
        "from sparkdl_tpu_torch.core import executor, health\n"
        "from sparkdl_tpu_torch.image import imageIO\n"
        "s.EngineConfig.device = 'cpu'\n"
        "s.EngineConfig.inference_precision = 'float32'\n"
        "s.EngineConfig.max_workers = 3\n"
        "rng = np.random.default_rng(0)\n"
        "imgs = [rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)\n"
        "        for _ in range(3)]\n"
        "col = imageIO.imageArraysToStructColumn(imgs, list('abc'))\n"
        "df = s.DataFrame.fromColumns({'image': col}, numPartitions=3)\n"
        "for name, dim in (('Xception', 2048), ('InceptionV3', 2048),\n"
        "                  ('TestNet', 16)):\n"
        "    with health.HealthMonitor() as mon:\n"
        "        rows = s.DeepImageFeaturizer(inputCol='image',\n"
        "            outputCol='f', modelName=name,\n"
        "            batchSize=2).transform(df).collect()\n"
        "    assert len(rows) == 3 and len(rows[0]['f']) == dim\n"
        "    assert mon.count(health.TASK_STARTED) == 3\n"
        "assert any(t.name.startswith('sparkdl-part')\n"
        "           for t in threading.enumerate())\n"
        "assert executor.status()['models']\n"
        "executor.shutdown()\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                    'sparkdl_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_training_on_cpu_loads_no_jax(tmp_path):
    """A fit of TestNet with checkpoints, a resume and a debug-mode step,
    in a fresh process on the CPU, leaves no JAX and no ``sparkdl_tpu``
    in ``sys.modules``."""
    script = tmp_path / "train.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "import sparkdl_tpu_torch as s\n"
        "from sparkdl_tpu_torch.core.debug import debug_mode\n"
        "from sparkdl_tpu_torch.models.testnet import TestNet\n"
        "s.EngineConfig.device = 'cpu'\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)\n"
        "y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]\n"
        "batches = [(x[:8], y[:8]), (x[8:], y[8:])]\n"
        "trainer, state = s.Trainer.from_module(TestNet())\n"
        "ckpt = s.CheckpointManager(sys.argv[1])\n"
        "state = trainer.fit(state, batches, epochs=2, checkpoint=ckpt,\n"
        "                    checkpoint_every=1)\n"
        "_, fresh = s.Trainer.from_module(TestNet())\n"
        "assert int(ckpt.restore(fresh).step) == 4\n"
        "with debug_mode():\n"
        "    trainer.fit(state, batches[:1], epochs=1)\n"
        "ckpt.close()\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                    'sparkdl_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "c")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_serving_on_cpu_loads_no_jax(tmp_path):
    """A deployment served through ``ModelServer`` with a live telemetry
    scope (exporter and SLO watchdog on), a shadow and a cutover, in a
    fresh process on the CPU, leaves no JAX and no ``sparkdl_tpu`` in
    ``sys.modules``."""
    script = tmp_path / "serve.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "import sparkdl_tpu_torch as s\n"
        "from sparkdl_tpu_torch.models import registry\n"
        "s.EngineConfig.device = 'cpu'\n"
        "reg = s.ModelRegistry(residency=s.ResidencyManager(1 << 20))\n"
        "for v, seed in (('v1', 0), ('v2', 1)):\n"
        "    reg.deploy('tn', v, loader=lambda seed=seed:\n"
        "               registry.build_featurizer('TestNet', seed=seed),\n"
        "               latency_target_ms=500)\n"
        "srv = s.ModelServer(reg)\n"
        "rules = s.slo.default_serving_rules(reg.targets(), window_s=5)\n"
        f"with s.Telemetry(out_dir={str(tmp_path)!r}, window_s=5,\n"
        "                 export_interval_s=0.05, slo_rules=rules) as tel:\n"
        "    reg.shadow('tn', 'v2', fraction=1.0)\n"
        "    row = np.zeros((32, 32, 3), np.uint8)\n"
        "    assert srv.predict('tn', row).shadowed\n"
        "    srv.cutover('tn', 'v2')\n"
        "    assert srv.predict('tn', row).version == 'v2'\n"
        "assert tel.report()['timeline']['snapshots'] >= 1\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                    'sparkdl_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_ingest_loads_its_own_loader_and_no_jax(tmp_path):
    """``readImages`` with the decode pool on, in a fresh process: its
    decode workers map the port's own native loader
    (``build/sparkdl_tpu_torch/libimage_loader_*.so``), no process maps
    the JAX package's ``libsparkdl_image.so``, and no JAX and no
    ``sparkdl_tpu`` is imported."""
    images = tmp_path / "images"
    images.mkdir()
    script = tmp_path / "ingest.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "import sparkdl_tpu_torch as s\n"
        "from sparkdl_tpu_torch.core import decode_pool\n"
        "from sparkdl_tpu_torch.native import loader\n"
        "if __name__ == '__main__':\n"
        f"    root = {str(images)!r}\n"
        "    for i in range(4):\n"
        "        Image.fromarray(np.full((9, 7 + i, 3), i, np.uint8)).save(\n"
        "            f'{root}/{i}.png')\n"
        "    s.EngineConfig.decode_workers = 2\n"
        "    rows = s.readImages(root, numPartition=1).collect()\n"
        "    assert [r['image']['width'] for r in rows] == [7, 8, 9, 10]\n"
        "    pids = [w.proc.pid for w in decode_pool.maybe_pool()._workers]\n"
        "    maps = [open(f'/proc/{p}/maps').read()\n"
        "            for p in ['self'] + pids]\n"
        "    decode_pool.shutdown()\n"
        "    print(loader.available(),\n"
        "          all('libimage_loader_' in m for m in maps[1:]),\n"
        "          any('libsparkdl_image' in m for m in maps))\n"
        "    top = {m.split('.')[0] for m in sys.modules}\n"
        "    print(sorted(top & {'jax', 'jaxlib', 'flax', 'sparkdl_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    built, own_loader, theirs = out.stdout.split("\n")[0].split()
    if built == "True":
        assert own_loader == "True"
    assert theirs == "False"
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_imports_no_pyarrow_or_cloudpickle():
    """The card's machine has neither: the spill format and the op-chain
    transport are the port's own."""
    files = sorted((ROOT / "sparkdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad.extend(f"{path.relative_to(ROOT)}: {n}" for n in names
                       if n.split(".")[0] in ("pyarrow", "cloudpickle"))
    assert not bad, bad


def test_durable_cluster_runs_with_pyarrow_cloudpickle_and_jax_blocked(
        tmp_path):
    """In a fresh process where importing pyarrow, cloudpickle or JAX
    fails (``sys.modules[name] = None``, in the workers too: they run the
    script's top again), a frame at the defaults imports neither the
    cluster package nor the journal; then a durable materialize on 2
    cluster workers equals the in-process rows, and neither the
    coordinator nor a worker holds any of the blocked modules."""
    script = tmp_path / "blocked.py"
    script.write_text(
        "import sys\n"
        "BLOCKED = ('pyarrow', 'cloudpickle', 'jax', 'jaxlib', 'flax',\n"
        "           'sparkdl_tpu')\n"
        "for name in BLOCKED:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "import sparkdl_tpu_torch as s\n"
        "\n"
        "def loaded(batch):\n"
        "    top = {m.split('.')[0] for m in sys.modules\n"
        "           if sys.modules[m] is not None}\n"
        "    return [','.join(sorted(top & set(BLOCKED)))] * batch.num_rows\n"
        "\n"
        "if __name__ == '__main__':\n"
        "    s.EngineConfig.device = 'cpu'\n"
        "    def frame(k=3):\n"
        "        df = s.DataFrame.fromColumns({'x': np.arange(12)},\n"
        "                                     numPartitions=4)\n"
        "        return (df.withColumnBatch('y', lambda b: b.column('x') * k)\n"
        "                .withColumnBatch('mods', loaded))\n"
        "    want = frame().collect()\n"
        "    print(sorted(m for m in sys.modules if m.startswith(\n"
        "        ('sparkdl_tpu_torch.cluster',\n"
        "         'sparkdl_tpu_torch.core.durability'))))\n"
        f"    s.EngineConfig.durable_dir = {str(tmp_path / 'durable')!r}\n"
        "    s.EngineConfig.cluster_workers = 2\n"
        "    from sparkdl_tpu_torch.cluster import router\n"
        "    got = frame().collect()\n"
        "    pids = [w.proc.pid for w in router.maybe_router()._workers]\n"
        "    router.shutdown()\n"
        "    assert [r['y'] for r in got] == [r['y'] for r in want]\n"
        "    print(sorted({r['mods'] for r in got}), len(pids))\n"
        "    print(loaded(s.DataFrame.fromColumns({'x': [1]})\n"
        "                 ._partitions[0]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    defaults, workers, coordinator = out.stdout.strip().splitlines()[-3:]
    assert defaults == "[]"
    assert workers == "[''] 2"
    assert coordinator == "['']"


def test_default_device_without_cuda_raises():
    """With the default ``EngineConfig.device = "cuda"`` and no card,
    ``transform`` raises instead of running on the CPU."""
    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.image import imageIO

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    assert s.EngineConfig.device == "cuda"
    img = np.zeros((8, 8, 3), np.uint8)
    df = s.DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn([img], ["a"])})
    feat = s.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                 modelName="Xception")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feat.transform(df)


def test_unported_models_say_so():
    """The reference's ingestion-backed names are not ported yet."""
    import sparkdl_tpu_torch as s

    feat = s.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                 modelName="DenseNet121")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        feat._model_function("featurize")
