"""The port's image column, DataFrame and image transformer against the
JAX package's (Arrow-backed) ones, on the same inputs.

Every comparison here is exact: no floating-point arithmetic differs
between the two (copies, PIL resizes, and a multiply by 0.5).
"""

import numpy as np
import pyarrow as pa
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.core.model_function import ModelFunction as JaxModelFunction
from sparkdl_tpu.core.model_function import TensorSpec as JaxTensorSpec
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    yield
    EngineConfig.restore(saved)


def _arrays(kind: str):
    rng = np.random.default_rng(21)
    if kind == "uniform":
        return [rng.integers(0, 256, (5, 4, 3), dtype=np.uint8), None,
                rng.integers(0, 256, (5, 4, 3), dtype=np.uint8)]
    return [rng.integers(0, 256, (5, 4, 3), dtype=np.uint8),
            rng.normal(size=(3, 6, 1)).astype(np.float32), None,
            rng.integers(0, 256, (7, 2), dtype=np.uint8)]


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_image_column_matches_reference(kind):
    arrays = _arrays(kind)
    origins = [f"o{i}" for i in range(len(arrays))]
    ours = imageIO.imageArraysToStructColumn(arrays, origins)
    ref = jax_imageIO.imageArraysToStructColumn(arrays, origins)
    assert ours.to_pylist() == ref.to_pylist()
    fast, ref_fast = (imageIO.uniformImageBatch(ours),
                      jax_imageIO.arrowImageBatch(ref))
    if kind == "uniform":
        np.testing.assert_array_equal(fast[0], ref_fast[0])
        np.testing.assert_array_equal(fast[1], ref_fast[1])
    else:
        assert fast is None and ref_fast is None
    # partitions slice the column without losing rows or nulls
    assert (ours.slice(1, 3).to_pylist() + ours.slice(0, 1).to_pylist()
            == ref.to_pylist()[1:3] + ref.to_pylist()[:1])


def test_dataframe_ops_match_reference():
    rows = [{"id": i, "name": f"n{i}", "x": float(i) / 3} for i in range(5)]
    frames = [pkg.DataFrame.fromRows(rows, numPartitions=2)
              for pkg in (sparkdl_tpu, sparkdl_tpu_torch)]
    outs = []
    for df in frames:
        assert df.numPartitions == 2 and df.count() == 5
        out = df.withColumn("y", lambda v: v * 2, inputCols=["x"])
        out = out.drop("name").select("y", "id")
        assert out.columns == ["y", "id"]
        outs.append(out.collect())
    assert outs[0] == outs[1]


def _corrupt_column_rows():
    rng = np.random.default_rng(22)
    structs = [jax_imageIO.imageArrayToStruct(
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8), origin=f"r{h}")
        for h, w in ((9, 7), (6, 5), (4, 11))]
    structs.insert(1, dict(structs[0], data=b"\x00" * 5, origin="bad"))
    structs.append(None)
    return [{"image": s} for s in structs]


@pytest.mark.parametrize("mode", ["vector", "image"])
def test_image_transformer_ragged_path_matches_reference(mode):
    """Ragged sizes take the per-row path: host resize to the model's
    6×5, a malformed struct and a null row become null cells."""
    rows = _corrupt_column_rows()
    jdf = sparkdl_tpu.DataFrame.fromArrow(pa.table(
        {"image": pa.array([r["image"] for r in rows],
                           type=jax_imageIO.imageSchema)}))
    tdf = sparkdl_tpu_torch.DataFrame.fromRows(rows)
    kw = dict(inputCol="image", outputCol="out", outputMode=mode,
              batchSize=4)
    jmf = JaxModelFunction.fromFunction(
        lambda vs, x: x * 0.5, None, JaxTensorSpec((None, 6, 5, 3)))
    tmf = ModelFunction(lambda vs, x: x * 0.5, None,
                        TensorSpec((None, 6, 5, 3)))
    ref = sparkdl_tpu.TPUImageTransformer(modelFunction=jmf, **kw) \
        .transform(jdf).collect()
    ours = sparkdl_tpu_torch.TFImageTransformer(modelFunction=tmf, **kw) \
        .transform(tdf).collect()
    assert [r["out"] is None for r in ours] == [False, True, False, False,
                                                True]
    assert [r["out"] for r in ours] == [r["out"] for r in ref]
