"""The ingest stack of the port against the JAX package's.

The same seeded files and structs go through both packages: decode
fault injection (``decode_error``) on ``readImages`` and on the tolerant
struct staging, the native libjpeg/libpng loader (each package builds
its own copy of the source; pixels must agree bit for bit), the batch
decoders, the host resize, ``CanLoadImage`` and the host-downscale
branch of the featurizer (``EngineConfig.fused_preprocess = False``).

Tolerances: pixels and null rows exact; features of the host-downscale
branch, float32, whole model: max|Δ| ≤ 1e-3·max|ref|.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import resilience as jax_resilience
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu_torch.core import health, resilience
from sparkdl_tpu_torch.image import imageIO


def _jpeg(arr, quality=90):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _png(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Twelve JPEG/PNG files of mixed sizes and channels and one corrupt
    file, from a fixed seed."""
    root = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(5)
    for i in range(12):
        h, w = 20 + 3 * i, 24 + 2 * (i % 4)
        if i % 4 == 3:
            arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
        else:
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = _png(arr) if i % 3 == 0 else _jpeg(arr)
        ext = "png" if i % 3 == 0 else "jpg"
        (root / f"img_{i:02d}.{ext}").write_bytes(data)
    (root / "img_99_bad.jpg").write_bytes(b"\xff\xd8\xff not a jpeg")
    return root


def _faults(fault_module, kind):
    """One armed ``decode_error`` of each kind, built in ``fault_module``
    (each package has its own injector): a seeded rate of 0.3 (a fresh
    generator each time, so both packages see the same draws) or the
    occurrences 3 and 4."""
    if kind == "rate":
        draws = random.Random(11)
        return fault_module.Fault(times=-1,
                                  when=lambda ctx: draws.random() < 0.3)
    return fault_module.Fault(after=3, times=2)


def _null_rows(rows):
    return [i for i, r in enumerate(rows) if r["image"] is None]


@pytest.mark.parametrize("kind", ["rate", "occurrence"])
def test_decode_error_on_read_images_matches_reference(image_dir, kind):
    """With ``decode_error`` armed, the port's ``readImages`` turns the
    reference's rows to null and counts the same ``decode_degraded``
    events (one partition: the order of the checks is the files')."""
    with jax_resilience.FaultInjector.seeded(
            0, decode_error=_faults(jax_resilience, kind)) as jinj, \
            jax_health.HealthMonitor() as jmon:
        jrows = jax_imageIO.readImages(str(image_dir),
                                       numPartition=1).collect()
    with resilience.FaultInjector.seeded(
            0, decode_error=_faults(resilience, kind)) as inj, \
            health.HealthMonitor() as mon:
        rows = imageIO.readImages(str(image_dir), numPartition=1).collect()
    assert inj.fired == jinj.fired and inj.fired["decode_error"] >= 2
    nulls = _null_rows(rows)
    assert nulls == _null_rows(jrows) and 12 in nulls and len(nulls) > 2
    assert mon.count(health.DECODE_DEGRADED) \
        == jmon.count(jax_health.DECODE_DEGRADED) == len(nulls)
    assert [r["image"] for r in rows] == [r["image"] for r in jrows]


@pytest.mark.parametrize("kind", ["rate", "occurrence"])
def test_decode_error_on_tolerant_staging_matches_reference(kind):
    """The tolerant struct staging fires ``decode_error`` once per row
    and degrades whatever a row raises, as the reference does (a mode of
    infinity raises OverflowError)."""
    rng = np.random.default_rng(6)
    structs = [imageIO.imageArrayToStruct(
        rng.integers(0, 256, (6, 5, 3), dtype=np.uint8), origin=f"r{i}")
        for i in range(16)]
    structs[2] = dict(structs[2], mode=float("inf"))
    structs[6] = dict(structs[6], height=7)
    with jax_resilience.FaultInjector.seeded(
            0, decode_error=_faults(jax_resilience, kind)) as jinj, \
            jax_health.HealthMonitor() as jmon:
        jbatch, jkept, jdropped = \
            jax_imageIO.imageStructsToBatchArrayTolerant(structs, (4, 4))
    with resilience.FaultInjector.seeded(
            0, decode_error=_faults(resilience, kind)) as inj, \
            health.HealthMonitor() as mon:
        batch, kept, dropped = imageIO.imageStructsToBatchArrayTolerant(
            structs, (4, 4))
    assert inj.fired == jinj.fired and inj.fired["decode_error"] >= 2
    assert kept == jkept and dropped == jdropped == 16 - len(kept)
    assert 2 not in kept and 6 not in kept and dropped > 2
    np.testing.assert_array_equal(batch, jbatch)
    assert mon.count(health.DECODE_DEGRADED) \
        == jmon.count(jax_health.DECODE_DEGRADED)


# ---------------------------------------------------------------------------
# The native loader: each package's build of the same source
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loaders():
    """The port's loader and the JAX package's; skips only where the
    toolchain (g++, libjpeg and libpng headers) cannot build them."""
    from sparkdl_tpu.native import loader as jax_loader
    from sparkdl_tpu_torch.native import loader

    if not loader.available():
        pytest.skip(f"native loader not built: {loader.unavailable_reason}")
    assert jax_loader.available()
    return loader, jax_loader


def _gray_trns(rng):
    arr = rng.integers(0, 255, (16, 16), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG", transparency=128)
    return buf.getvalue()


#: (blob maker, target size, expected output shape)
DECODE_CASES = {
    "png": (lambda r: _png(r.integers(0, 255, (57, 43, 3), np.uint8)),
            None, (57, 43, 3)),
    "jpeg": (lambda r: _jpeg(r.integers(0, 255, (64, 48, 3), np.uint8), 95),
             None, (64, 48, 3)),
    "jpeg_resized": (lambda r: _jpeg(r.integers(0, 255, (70, 90, 3),
                                                np.uint8)),
                     (31, 29), (31, 29, 3)),
    "grayscale": (lambda r: _png(r.integers(0, 255, (20, 20), np.uint8)),
                  None, (20, 20, 1)),
    "rgba": (lambda r: _png(r.integers(0, 255, (10, 12, 4), np.uint8)),
             None, (10, 12, 4)),
    "grayscale_trns": (_gray_trns, None, (16, 16, 2)),
    # a target far below the source: libjpeg decodes at 1/8 first
    "jpeg_dct_scaled": (lambda r: _jpeg(r.integers(0, 255, (512, 512, 3),
                                                   np.uint8)),
                        (64, 64), (64, 64, 3)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_loader_decode_matches_reference_bit_for_bit(loaders, case):
    loader, jax_loader = loaders
    make, target, shape = DECODE_CASES[case]
    blob = make(np.random.default_rng(7))
    ours = loader.decode(blob, target_size=target)
    ref = jax_loader.decode(blob, target_size=target)
    assert ours.shape == shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    assert loader.decode(b"not an image") is None


def test_loader_batch_with_a_corrupt_member_matches_reference(loaders):
    """The batch decoder forces RGB at one size; a corrupt member fails
    alone (its flag), and ``decode_batch`` then returns None."""
    loader, jax_loader = loaders
    rng = np.random.default_rng(8)
    blobs = [_jpeg(rng.integers(0, 255, (40 + i, 30, 3), np.uint8))
             for i in range(4)]
    blobs.insert(2, b"garbage")
    blobs.append(_png(rng.integers(0, 255, (16, 16), np.uint8)))
    out, ok = loader.decode_batch_status(blobs, (24, 20))
    ref, ref_ok = jax_loader.decode_batch_status(blobs, (24, 20))
    assert out.shape == (6, 24, 20, 3)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok.tolist() == [True, True, False, True, True, True]
    np.testing.assert_array_equal(out[ok], ref[ok])
    np.testing.assert_array_equal(out[5, :, :, 0], out[5, :, :, 1])
    assert loader.decode_batch(blobs, (24, 20)) is None
    np.testing.assert_array_equal(
        loader.decode_batch(blobs[:2], (24, 20)),
        jax_loader.decode_batch(blobs[:2], (24, 20)))


@pytest.mark.parametrize("shape,target", [((3, 70, 90, 3), (33, 41)),
                                          ((2, 20, 24, 1), (47, 31)),
                                          ((1, 384, 384, 3), (299, 299))])
def test_loader_resize_batch_matches_reference(loaders, shape, target):
    loader, jax_loader = loaders
    batch = np.random.default_rng(9).integers(0, 256, shape, np.uint8)
    ours = loader.resize_batch(batch, target)
    assert ours.shape == (shape[0], *target, shape[3])
    np.testing.assert_array_equal(ours, jax_loader.resize_batch(batch,
                                                                target))
    assert loader.resize_batch(batch.astype(np.float32), target) is None


# ---------------------------------------------------------------------------
# The decode stack and the host resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,target", [((2, 37, 41, 3), (16, 20)),
                                          ((1, 9, 7, 1), (23, 17)),
                                          ((2, 8, 8, 3), (8, 8))])
def test_resize_batch_array_matches_reference(shape, target, dtype):
    rng = np.random.default_rng(10)
    batch = (rng.integers(0, 256, shape) if dtype == np.uint8
             else rng.normal(size=shape) * 50).astype(dtype)
    ours = imageIO.resizeBatchArray(batch, target)
    assert ours.dtype == dtype and ours.shape[1:3] == target
    np.testing.assert_array_equal(ours,
                                  jax_imageIO.resizeBatchArray(batch, target))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_bytes_batch_matches_reference(channels):
    """Mixed JPEG/PNG, grayscale and RGBA blobs, a corrupt one and a
    missing one, at one size: the same arrays, the same Nones and the
    same decode_degraded counts. (The JAX package's native batch call
    writes three channels whatever ``channels`` is, past the end of its
    buffer for 1; the port takes Pillow for 1 and 4, as the JAX package
    does for any blob its native call rejects.)"""
    rng = np.random.default_rng(12)
    blobs = [_jpeg(rng.integers(0, 255, (30, 26, 3), np.uint8)),
             _png(rng.integers(0, 255, (18, 22), np.uint8)),
             b"corrupt", None,
             _png(rng.integers(0, 255, (12, 14, 4), np.uint8)),
             _jpeg(rng.integers(0, 255, (40, 40, 3), np.uint8))]
    with health.HealthMonitor() as mon:
        ours = imageIO.decodeImageBytesBatch(blobs, (16, 16), channels)
    assert [a is None for a in ours] == [False, False, True, True, False,
                                         False]
    assert mon.count(health.DECODE_DEGRADED) == 1
    if channels != 3:
        for a in ours:
            assert a is None or a.shape == (16, 16, channels)
        return
    with jax_health.HealthMonitor() as jmon:
        ref = jax_imageIO.decodeImageBytesBatch(blobs, (16, 16), channels)
    assert jmon.count(jax_health.DECODE_DEGRADED) == 1
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("target,channels", [(None, None), (None, 3),
                                             ((20, 18), None),
                                             ((20, 18), 3)])
def test_decode_image_file_matches_reference(image_dir, target, channels):
    for path in sorted(image_dir.iterdir()):
        ours = imageIO.decodeImageFile(str(path), target_size=target,
                                       channels=channels)
        ref = jax_imageIO.decodeImageFile(str(path), target_size=target,
                                          channels=channels)
        if ref is None:
            assert ours is None, path
            continue
        ref = ref[:, :, None] if ref.ndim == 2 else ref
        np.testing.assert_array_equal(ours, ref)


def test_read_images_matches_reference(image_dir):
    """readImages over the mixed directory (pool off): the same rows, in
    three partitions, the corrupt file's struct null."""
    rows = imageIO.readImages(str(image_dir), numPartition=3).collect()
    ref = jax_imageIO.readImages(str(image_dir), numPartition=3).collect()
    assert rows == ref and rows[-1]["image"] is None


# ---------------------------------------------------------------------------
# CanLoadImage
# ---------------------------------------------------------------------------

def _load_frames(image_dir, null_uri):
    uris = [f"file:{p}" for p in sorted(image_dir.iterdir())]
    uris += [None] if null_uri else []
    jdf = sparkdl_tpu.DataFrame.fromRows([{"uri": u} for u in uris],
                                         numPartitions=2)
    tdf = sparkdl_tpu_torch.DataFrame.fromColumns({"uri": uris},
                                                  numPartitions=2)
    return jdf, tdf


@pytest.mark.parametrize("target,custom", [((20, 18), False),
                                           (None, False), ((20, 18), True)])
def test_load_images_internal_matches_reference(image_dir, target, custom):
    """loadImagesInternal's batch path (a target size, the default
    loader), its per-row path (no target: channels=3) and a custom
    loader give the reference's structs (a null URI only on the batch
    path: the reference's per-row path raises on one)."""
    from sparkdl_tpu.param.shared_params import CanLoadImage as JaxLoader
    from sparkdl_tpu_torch.param import CanLoadImage

    def custom_loader(uri):
        arr = imageIO.decodeImageFile(uri, channels=3)
        return None if arr is None else arr[::2, ::2]

    batch_path = target is not None and not custom
    jdf, tdf = _load_frames(image_dir, null_uri=batch_path)
    ours, ref = CanLoadImage(), JaxLoader()
    if custom:
        ours.setImageLoader(custom_loader)
        ref.setImageLoader(custom_loader)
    rows = ours.loadImagesInternal(tdf, "uri", "image",
                                   target_size=target).collect()
    jrows = ref.loadImagesInternal(jdf, "uri", "image",
                                   target_size=target).collect()
    assert [r["image"] for r in rows] == [r["image"] for r in jrows]
    assert sum(r["image"] is None for r in rows) == 1 + batch_path
    assert rows[0]["image"]["nChannels"] == 3
    ours.setImageLoader(None)
    assert ours.getImageLoader() is None


# ---------------------------------------------------------------------------
# EngineConfig.fused_preprocess = False: the host downscale
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def testnet_weights():
    from sparkdl_tpu.models.testnet import TestNet
    from tests.torch_port_helpers import headless, random_variables

    return headless(random_variables(TestNet(include_top=True),
                                     (1, 32, 32, 3), seed=57))


@pytest.mark.parametrize("source", [(48, 44), (24, 20)])
def test_host_downscale_branch_matches_reference(testnet_weights, source):
    """With ``fused_preprocess`` off, a 48×44 batch is resized to TestNet's
    32×32 on the host (the native loader's resize, a
    ``sparkdl.host_resize`` span) and a 24×20 one still on the device; the
    features hold against the JAX package's same branch (float32,
    1e-3·max|ref|)."""
    from sparkdl_tpu.engine.dataframe import EngineConfig as JaxConfig
    from sparkdl_tpu_torch.core import profiling
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig
    from tests.torch_port_helpers import column, frames, max_abs

    rng = np.random.default_rng(58)
    images = [rng.integers(0, 256, (*source, 3), dtype=np.uint8)
              for _ in range(3)]
    jdf, tdf = frames(images, ["a", "b", "c"])
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              weights=testnet_weights, batchSize=2)
    saved, jsaved = EngineConfig.snapshot(), JaxConfig.snapshot()
    try:
        EngineConfig.device = "cpu"
        EngineConfig.inference_precision = "float32"
        EngineConfig.fused_preprocess = JaxConfig.fused_preprocess = False
        ref = column(sparkdl_tpu.DeepImageFeaturizer(**kw), jdf, "features")
        profiling.reset_phase_stats()
        ours = column(sparkdl_tpu_torch.DeepImageFeaturizer(**kw), tdf,
                      "features")
        host = profiling.phase_stats().get("sparkdl.host_resize")
    finally:
        EngineConfig.restore(saved)
        JaxConfig.restore(jsaved)
    assert ours.shape == (3, 16) and np.isfinite(ours).all()
    assert max_abs(ours, ref) <= 1e-3 * np.abs(ref).max()
    assert (host is not None) == (source == (48, 44))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_chip_smoke_png_encoder_round_trips(channels):
    """chip_smoke's standard-library PNG encoder (its files where Pillow
    is missing) writes files that Pillow and the port's decoder read back
    exactly."""
    import chip_smoke

    arr = np.random.default_rng(13).integers(0, 256, (9, 11, channels),
                                             dtype=np.uint8)
    blob = chip_smoke.png_bytes(arr)
    pil = np.asarray(Image.open(io.BytesIO(blob)))
    np.testing.assert_array_equal(pil.reshape(arr.shape), arr)
    np.testing.assert_array_equal(imageIO.decodeImageBytes(blob), arr)
