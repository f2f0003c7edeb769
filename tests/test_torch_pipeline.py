"""The flagship workflow as a whole, against the JAX package:
``Pipeline([DeepImageFeaturizer("TestNet"), LogisticRegression])`` fit
on the same images in both packages, the weights carried across by
``from_flax_variables`` (the featurizer takes the Flax tree), then
``transform`` and the three evaluators. Predictions equal, probabilities
within float32's ``1e-3·max|ref|``, every evaluator value equal to the
reference's. Then the ``Pipeline`` semantics the reference keeps: ``copy``
fans its param map out to every stage, stages after the last estimator
are not run during ``fit``, and ``fit`` with a list of param maps fits
one model per map. CPU only, float32.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import sparkdl_tpu
import sparkdl_tpu.ml as jax_ml
import sparkdl_tpu_torch
import sparkdl_tpu_torch.ml as torch_ml
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.core import executor
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.base import Pipeline, PipelineModel, Transformer
from tests.torch_port_helpers import headless, random_variables

F32_REL = 1e-3
N, PARTS = 24, 3


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 3
    yield
    executor.reset()
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def variables():
    return random_variables(jax_testnet.TestNet(include_top=True),
                            (1, 32, 32, 3), seed=131)


@pytest.fixture(scope="module")
def images():
    """Two classes, as in the flagship example: class c brightens
    channel c."""
    rng = np.random.default_rng(132)
    arrays, labels = [], []
    for i in range(N):
        label = i % 2
        arr = rng.integers(0, 60, size=(32, 32, 3), dtype=np.uint8)
        arr[..., label] += 150
        arrays.append(arr)
        labels.append(label)
    return arrays, labels


def _frames(images):
    arrays, labels = images
    origins = [f"img{i}" for i in range(N)]
    ref = sparkdl_tpu.DataFrame.fromArrow(pa.table({
        "image": jax_imageIO.imageArraysToStructColumn(arrays, origins),
        "label": pa.array(labels)}), numPartitions=PARTS)
    ours = sparkdl_tpu_torch.DataFrame.fromColumns({
        "image": imageIO.imageArraysToStructColumn(arrays, origins),
        "label": labels}, numPartitions=PARTS)
    return ref, ours


def _pipeline(ml, variables):
    return ml.Pipeline(stages=[
        ml.DeepImageFeaturizer(inputCol="image", outputCol="features",
                               modelName="TestNet",
                               weights=headless(variables), batchSize=8),
        ml.LogisticRegression(maxIter=50, regParam=0.01)])


EVALUATORS = (
    [("MulticlassClassificationEvaluator", dict(metricName=m))
     for m in ("f1", "accuracy", "weightedPrecision", "weightedRecall")]
    + [("RegressionEvaluator", dict(metricName=m))
       for m in ("rmse", "mse", "mae", "r2")]
    + [("BinaryClassificationEvaluator",
        dict(rawPredictionCol="probability", metricName=m))
       for m in ("areaUnderROC", "areaUnderPR")])


def test_testnet_pipeline_matches_reference(variables, images):
    ref_df, our_df = _frames(images)
    ref_model = _pipeline(jax_ml, variables).fit(ref_df)
    our_model = _pipeline(torch_ml, variables).fit(our_df)
    assert isinstance(our_model, PipelineModel)
    assert our_model.stages[1].numIterations == \
        ref_model.stages[1].numIterations
    ref_scored = ref_model.transform(ref_df)
    our_scored = our_model.transform(our_df)
    ref_rows, our_rows = ref_scored.collect(), our_scored.collect()
    assert [r["prediction"] for r in our_rows] \
        == [r["prediction"] for r in ref_rows]
    rp = np.array([r["probability"] for r in ref_rows], np.float32)
    op = np.array([r["probability"] for r in our_rows], np.float32)
    assert float(np.abs(op - rp).max()) <= F32_REL * float(np.abs(rp).max())
    for name, params in EVALUATORS:
        ref_val = getattr(jax_ml, name)(**params).evaluate(ref_scored)
        our_val = getattr(torch_ml, name)(**params).evaluate(our_scored)
        assert our_val == ref_val, (name, params, our_val, ref_val)


def test_evaluators_match_reference_with_null_rows():
    rng = np.random.default_rng(133)
    pred = [float(v) for v in rng.integers(0, 3, 40)]
    label = [float(v) for v in rng.integers(0, 3, 40)]
    score = rng.uniform(size=40).tolist()
    binary = [float(v) for v in rng.integers(0, 2, 40)]
    for i in (3, 11, 27):
        pred[i] = None
    label[19] = None
    cols = {"prediction": pred, "label": label, "score": score,
            "binary": binary}
    ref = sparkdl_tpu.DataFrame.fromRows(
        [{k: v[i] for k, v in cols.items()} for i in range(40)],
        numPartitions=4)
    ours = sparkdl_tpu_torch.DataFrame.fromColumns(cols, numPartitions=4)
    evaluators = EVALUATORS[:8] + [
        ("BinaryClassificationEvaluator",
         dict(rawPredictionCol="score", labelCol="binary", metricName=m))
        for m in ("areaUnderROC", "areaUnderPR")]
    for name, params in evaluators:
        r = getattr(jax_ml, name)(**params)
        o = getattr(torch_ml, name)(**params)
        assert o.evaluate(ours) == r.evaluate(ref), (name, params)
        assert o.isLargerBetter() == r.isLargerBetter()
    empty = sparkdl_tpu_torch.DataFrame.fromColumns(
        {"prediction": [None], "label": [1.0]})
    with pytest.raises(ValueError, match="no non-null"):
        sparkdl_tpu_torch.MulticlassClassificationEvaluator().evaluate(empty)


class _Counting(Transformer):
    """Adds a copy of ``label`` as ``name``; counts its transforms."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.calls = 0

    def _transform(self, dataset):
        self.calls += 1
        return dataset.withColumn(self.name, lambda v: v,
                                  inputCols=["label"])


def _numeric_frame():
    rng = np.random.default_rng(134)
    y = rng.integers(0, 2, 30)
    x = (rng.normal(size=(30, 4)) + y[:, None]).astype(np.float32)
    return sparkdl_tpu_torch.DataFrame.fromColumns(
        {"features": x, "label": y.tolist()}, numPartitions=2)


def test_stages_after_the_last_estimator_are_not_run_during_fit():
    before, after = _Counting("a"), _Counting("b")
    lr = sparkdl_tpu_torch.LogisticRegression(maxIter=5)
    model = Pipeline(stages=[before, lr, after]).fit(_numeric_frame())
    assert (before.calls, after.calls) == (1, 0)
    assert model.stages[0] is before and model.stages[2] is after
    out = model.transform(_numeric_frame())
    assert (before.calls, after.calls) == (2, 1)
    assert {"a", "b", "prediction", "probability"} <= set(out.columns)


def test_copy_fans_the_param_map_out_to_every_stage():
    lr = sparkdl_tpu_torch.LogisticRegression(maxIter=5)
    feat = sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="f", modelName="TestNet", batchSize=8)
    pipe = Pipeline(stages=[feat, lr])
    copied = pipe.copy({lr.maxIter: 9, feat.batchSize: 4})
    new_feat, new_lr = copied.getStages()
    assert new_lr.getMaxIter() == 9 and new_feat.getBatchSize() == 4
    assert lr.getMaxIter() == 5 and feat.getBatchSize() == 8
    assert new_lr is not lr and new_feat is not feat


def test_fit_with_a_list_of_param_maps_fits_one_model_per_map():
    lr = sparkdl_tpu_torch.LogisticRegression(maxIter=30)
    maps = [{lr.regParam: 0.0}, {lr.regParam: 1.0}, {lr.maxIter: 1}]
    df = _numeric_frame()
    models = lr.fit(df, maps)
    assert len(models) == 3
    singles = [lr.fit(df, m) for m in maps]
    for got, want in zip(models, singles):
        assert np.array_equal(got.coefficients, want.coefficients)
        assert got.numIterations == want.numIterations
    assert models[2].numIterations == 1
    assert float(np.abs(models[1].coefficients).max()) \
        < float(np.abs(models[0].coefficients).max())
    # fitMultiple's iterator is safe to drain from threads
    seen, lock = [], threading.Lock()
    it = lr.fitMultiple(df, maps)

    def drain():
        for index, model in it:
            with lock:
                seen.append((index, model.numIterations))

    threads = [threading.Thread(target=drain) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(i for i, _ in seen) == [0, 1, 2]
    with pytest.raises(TypeError):
        lr.fit(df, "not a map")


def test_pipeline_model_copy_and_bad_stage():
    model = Pipeline(stages=[sparkdl_tpu_torch.LogisticRegression(
        maxIter=3)]).fit(_numeric_frame())
    twin = model.copy()
    assert twin.parent is model.parent
    assert twin.stages[0] is not model.stages[0]
    assert np.array_equal(twin.stages[0].coefficients,
                          model.stages[0].coefficients)
    with pytest.raises(TypeError, match="Estimator or Transformer"):
        Pipeline(stages=["nope"]).fit(_numeric_frame())
