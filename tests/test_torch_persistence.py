"""Persistence round trips of the port's stages (``ml/persistence.py``):
``save`` then ``load`` must reproduce each stage's outputs exactly.

The unfitted ``LogisticRegression`` and an evaluator (params only), the
fitted ``LogisticRegressionModel`` (``weights.npz``: probabilities equal
bit for bit), ``DeepImageFeaturizer`` with the seeded ``"random"``
weights (only the marker is saved; the rebuild's features are equal bit
for bit) and with explicit Flax weights (a torch state dict,
``weights.pt``), its ``dtype``, an unfitted ``Pipeline`` (reloaded, then
fit: the same model as the original's fit) and a fitted
``PipelineModel``. A class off the port's whitelist is refused, and
``TorchImageTransformer.save`` raises until its artifact is ported. CPU
only, float32.
"""

import json
import os

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.core import executor
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml import persistence
from sparkdl_tpu_torch.ml.base import Pipeline, PipelineModel
from sparkdl_tpu_torch.ml.classification import (
    LogisticRegression, LogisticRegressionModel,
)
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.models import registry
from tests.torch_port_helpers import headless, random_variables


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 2
    yield
    executor.reset()
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def image_frame():
    rng = np.random.default_rng(151)
    arrays, labels = [], []
    for i in range(12):
        arr = rng.integers(0, 60, size=(32, 32, 3), dtype=np.uint8)
        arr[..., i % 2] += 150
        arrays.append(arr)
        labels.append(i % 2)
    return sparkdl_tpu_torch.DataFrame.fromColumns({
        "image": imageIO.imageArraysToStructColumn(
            arrays, [f"img{i}" for i in range(12)]),
        "label": labels}, numPartitions=2)


@pytest.fixture(scope="module")
def flax_weights():
    return headless(random_variables(jax_testnet.TestNet(include_top=True),
                                     (1, 32, 32, 3), seed=152))


def _features(stage, df, col="features"):
    return np.stack([np.asarray(r[col], np.float32)
                     for r in stage.transform(df).collect()])


def _numeric_frame():
    rng = np.random.default_rng(153)
    y = rng.integers(0, 3, 40)
    x = (rng.normal(size=(40, 5)) + y[:, None]).astype(np.float32)
    return sparkdl_tpu_torch.DataFrame.fromColumns(
        {"features": x, "label": y.tolist()}, numPartitions=2)


def test_logistic_regression_estimator_round_trip(tmp_path):
    lr = LogisticRegression(maxIter=17, regParam=0.25, tol=1e-4,
                            fitIntercept=False, standardization=False,
                            weightCol="w", thresholds=[1.0, 2.0],
                            predictionCol="pred")
    lr.save(str(tmp_path / "lr"))
    back = sparkdl_tpu_torch.load(str(tmp_path / "lr"))
    assert type(back) is LogisticRegression
    assert {p.name: back.getOrDefault(p) for p in back.params
            if back.isDefined(p)} == {p.name: lr.getOrDefault(p)
                                      for p in lr.params if lr.isDefined(p)}
    meta = json.loads((tmp_path / "lr" / "metadata.json").read_text())
    assert meta["class"] == \
        "sparkdl_tpu_torch.ml.classification.LogisticRegression"
    assert meta["artifacts"] == {}


def test_logistic_regression_model_round_trip_is_exact(tmp_path):
    df = _numeric_frame()
    model = LogisticRegression(maxIter=30, regParam=0.1,
                               thresholds=[1.0, 0.5, 2.0]).fit(df)
    model.save(str(tmp_path / "m"))
    back = sparkdl_tpu_torch.load(str(tmp_path / "m"))
    assert type(back) is LogisticRegressionModel
    assert os.path.exists(tmp_path / "m" / "weights.npz")
    assert np.array_equal(back.coefficients, model.coefficients)
    assert np.array_equal(back.intercept, model.intercept)
    assert back.getThresholds() == [1.0, 0.5, 2.0]
    a, b = model.transform(df).collect(), back.transform(df).collect()
    assert all(np.array_equal(x["probability"], y["probability"])
               and x["prediction"] == y["prediction"] for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["MulticlassClassificationEvaluator",
                                  "RegressionEvaluator",
                                  "BinaryClassificationEvaluator"])
def test_evaluator_round_trip(tmp_path, name):
    cls = getattr(sparkdl_tpu_torch, name)
    metric = {"MulticlassClassificationEvaluator": "accuracy",
              "RegressionEvaluator": "mae",
              "BinaryClassificationEvaluator": "areaUnderPR"}[name]
    ev = cls(metricName=metric, labelCol="y")
    ev.save(str(tmp_path / "e"))
    back = sparkdl_tpu_torch.load(str(tmp_path / "e"))
    assert type(back) is cls
    assert back.getMetricName() == metric and back.getLabelCol() == "y"


@pytest.mark.parametrize("weights", ["random", "flax"])
def test_featurizer_round_trip_is_bit_identical(tmp_path, image_frame,
                                                flax_weights, weights):
    feat = sparkdl_tpu_torch.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="TestNet",
        weights="random" if weights == "random" else flax_weights,
        batchSize=4)
    before = _features(feat, image_frame)
    feat.save(str(tmp_path / "f"))
    meta = json.loads((tmp_path / "f" / "metadata.json").read_text())
    back = sparkdl_tpu_torch.load(str(tmp_path / "f"))
    if weights == "random":
        assert meta["params"]["weights"] == "random"
        assert meta["artifacts"] == {}
    else:
        assert meta["artifacts"] == {"weights": "weights.pt"}
        state = torch.load(tmp_path / "f" / "weights.pt", weights_only=True)
        assert all(v.device.type == "cpu" for v in state.values())
    assert type(back) is sparkdl_tpu_torch.DeepImageFeaturizer
    assert back.getModelName() == "TestNet" and back.getBatchSize() == 4
    assert np.array_equal(_features(back, image_frame), before)


def test_featurizer_and_predictor_keep_their_dtype(tmp_path, image_frame):
    pred = sparkdl_tpu_torch.DeepImagePredictor(
        inputCol="image", outputCol="p", modelName="TestNet",
        weights=registry.build_predictor("TestNet").variables.state_dict(),
        dtype=torch.bfloat16, decodePredictions=True, topK=2)
    rows = pred.transform(image_frame).collect()
    pred.save(str(tmp_path / "p"))
    meta = json.loads((tmp_path / "p" / "metadata.json").read_text())
    assert meta["params"]["dtype"] == "bfloat16"
    back = sparkdl_tpu_torch.load(str(tmp_path / "p"))
    assert back.getDtype() == torch.bfloat16
    assert back.getOrDefault(back.topK) == 2
    assert back.transform(image_frame).collect() == rows


def test_unfitted_pipeline_round_trip_then_fit(tmp_path, image_frame):
    pipe = Pipeline(stages=[
        sparkdl_tpu_torch.DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="TestNet",
            batchSize=4),
        LogisticRegression(maxIter=20, regParam=0.05)])
    pipe.save(str(tmp_path / "pipe"))
    back = sparkdl_tpu_torch.load(str(tmp_path / "pipe"))
    assert type(back) is Pipeline
    assert [type(s) for s in back.getStages()] == \
        [type(s) for s in pipe.getStages()]
    a, b = pipe.fit(image_frame), back.fit(image_frame)
    assert np.array_equal(a.stages[1].coefficients, b.stages[1].coefficients)


def test_fitted_pipeline_model_round_trip_is_exact(tmp_path, image_frame,
                                                   flax_weights):
    model = Pipeline(stages=[
        sparkdl_tpu_torch.DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="TestNet",
            weights=flax_weights, batchSize=4),
        LogisticRegression(maxIter=20, regParam=0.05)]).fit(image_frame)
    model.save(str(tmp_path / "pm"))
    assert sorted(os.listdir(tmp_path / "pm")) == [
        "metadata.json", "stage_000_DeepImageFeaturizer",
        "stage_001_LogisticRegressionModel"]
    back = sparkdl_tpu_torch.load(str(tmp_path / "pm"))
    assert type(back) is PipelineModel
    a = model.transform(image_frame).collect()
    b = back.transform(image_frame).collect()
    assert all(np.array_equal(x["probability"], y["probability"])
               and np.array_equal(x["features"], y["features"])
               and x["prediction"] == y["prediction"] for x, y in zip(a, b))


def test_a_class_off_the_whitelist_is_refused(tmp_path):
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "metadata.json").write_text(json.dumps(
        {"class": "os.system", "params": {}, "artifacts": {}}))
    with pytest.raises(ValueError, match="Refusing to load"):
        persistence.load(str(tmp_path / "x"))
    (tmp_path / "x" / "metadata.json").write_text(json.dumps(
        {"class": "sparkdl_tpu.ml.classification.LogisticRegression",
         "params": {}, "artifacts": {}}))
    with pytest.raises(ValueError, match="Refusing to load"):
        persistence.load(str(tmp_path / "x"))


def test_torch_image_transformer_save_raises(tmp_path):
    t = TorchImageTransformer(inputCol="image", outputCol="f",
                              modelFunction=registry.build_featurizer(
                                  "TestNet"))
    with pytest.raises(NotImplementedError, match="StableHLO"):
        t.save(str(tmp_path / "t"))
    with pytest.raises(NotImplementedError):
        Pipeline(stages=[t]).save(str(tmp_path / "p"))


def test_a_non_json_param_refuses_to_save(tmp_path):
    lr = LogisticRegression(thresholds=[object()])
    with pytest.raises(ValueError, match="not JSON-serializable"):
        lr.save(str(tmp_path / "bad"))
