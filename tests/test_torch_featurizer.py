"""The slice as a whole: ``DeepImageFeaturizer``/``DeepImagePredictor``
with Xception in the port against the JAX package, same weights.

Three 64×80 uint8 images in one frame go through the user-facing path in
both packages (uniform column → on-device resize to 299×299 → tf-mode
normalize → Xception → 2048-d features), in float32 (the JAX tests pin
``inference_precision = "float32"`` in ``tests/conftest.py``; the port's
``EngineConfig`` is pinned the same way here, on the CPU).

Tolerance: float32, whole slice: max|Δ| ≤ 1e-3·max|ref| (36 conv layers
of reassociated sums, the folded BN of the sep2d route against the
reference's unfolded BN, and the resize's sums).
"""

import numpy as np
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.models.xception import Xception as JaxXception
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from tests.torch_port_helpers import (
    column, frames, headless, max_abs, random_variables,
)

F32_REL = 1e-3


@pytest.fixture(scope="module")
def variables():
    return random_variables(JaxXception(include_top=True), (1, 75, 75, 3),
                            seed=11)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    return [rng.integers(0, 256, size=(64, 80, 3), dtype=np.uint8)
            for _ in range(3)]


@pytest.fixture(autouse=True)
def cpu_engine(monkeypatch):
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    # every feasible kernel site routes (to its plain version on the CPU)
    monkeypatch.setattr(EngineConfig, "pallas_kernels", "force")
    yield
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def featurizers(variables):
    kw = dict(inputCol="image", outputCol="features", modelName="Xception",
              weights=headless(variables), batchSize=3)
    return (sparkdl_tpu.DeepImageFeaturizer(**kw),
            sparkdl_tpu_torch.DeepImageFeaturizer(**kw))


def test_featurizer_matches_reference(featurizers, images):
    jdf, tdf = frames(images, ["a", "b", "c"])
    ref = column(featurizers[0], jdf, "features")
    kernels.reset_launches()
    ours = column(featurizers[1], tdf, "features")
    assert ours.shape == (3, 2048) and np.isfinite(ours).all()
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()
    assert not any(kernels.launches.values())


def test_predictor_matches_reference(variables, images):
    jdf, tdf = frames(images, ["a", "b", "c"])
    kw = dict(inputCol="image", outputCol="probs", modelName="Xception",
              weights=variables, batchSize=3)
    ref = np.stack([r["probs"] for r in
                    sparkdl_tpu.DeepImagePredictor(**kw).transform(jdf)
                    .collect()])
    predictor = sparkdl_tpu_torch.DeepImagePredictor(**kw)
    ours = np.stack([r["probs"] for r in
                     predictor.transform(tdf).collect()])
    assert ours.shape == (3, 1000)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-5)
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()
    decoded = sparkdl_tpu_torch.DeepImagePredictor(
        decodePredictions=True, topK=3, **kw).transform(tdf).collect()
    for row, probs in zip(decoded, ours):
        top = np.argsort(-probs, kind="stable")[:3]
        assert [d["class"] for d in row["probs"]] == [f"class_{i}"
                                                      for i in top]
        np.testing.assert_allclose([d["probability"] for d in row["probs"]],
                                   probs[top])


def test_read_images_then_featurize(tmp_path, featurizers, images):
    """``readImages`` over JPEG files reads the same pixels as the JAX
    package's reader, and the frame featurizes to the same features."""
    from PIL import Image

    for i, arr in enumerate(images):
        Image.fromarray(arr).save(tmp_path / f"img_{i}.jpg", quality=95)
    (tmp_path / "notes.txt").write_text("not an image")
    jdf = sparkdl_tpu.readImages(str(tmp_path))
    tdf = sparkdl_tpu_torch.readImages(str(tmp_path))
    jrows, trows = jdf.collect(), tdf.collect()
    assert [r["filePath"] for r in trows] == [r["filePath"] for r in jrows]
    assert [r["image"] for r in trows] == [r["image"] for r in jrows]
    ref = column(featurizers[0], jdf, "features")
    ours = column(featurizers[1], tdf, "features")
    assert max_abs(ours, ref) <= F32_REL * np.abs(ref).max()


def test_read_images_through_the_decode_pool_then_featurize(
        tmp_path, featurizers, images):
    """The files → ``readImages`` → featurize slice with the decode pool
    on (two worker processes, three partitions): the rows are the JAX
    package's reader's, the features those of the pool off, bit for bit
    (test_read_images_then_featurize holds those against the JAX
    package)."""
    from PIL import Image

    from sparkdl_tpu_torch.core import decode_pool

    for i, arr in enumerate(images):
        Image.fromarray(arr).save(tmp_path / f"img_{i}.jpg", quality=95)
    ref_rows = sparkdl_tpu.readImages(str(tmp_path)).collect()
    off = column(featurizers[1], sparkdl_tpu_torch.readImages(str(tmp_path)),
                 "features")
    EngineConfig.decode_workers = 2
    try:
        tdf = sparkdl_tpu_torch.readImages(str(tmp_path), numPartition=3)
        assert tdf.collect() == ref_rows
        on = column(featurizers[1], tdf, "features")
    finally:
        decode_pool.shutdown()
    assert np.array_equal(on, off)
