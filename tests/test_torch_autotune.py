"""The port's kernel gate (``sparkdl_tpu_torch/core/kernels.py``) on the CPU.

Mirrors the JAX package's gate tests (``tests/core/test_kernels.py``):
the verdict store (round trip, merge, corrupt/stale/malformed files
discarded, in-process without a cache dir, verdicts partitioned by the
card), route gating in the three ``EngineConfig.pallas_kernels`` modes,
the CPU autotune path (clean rejections, features equal to ``"off"`` bit
for bit), and the site set a ``ModelFunction``'s first launch settles.
The decision logic runs with the backend check and the timer
monkeypatched, since the CPU has no card to time. The twins are held
against the JAX package's XLA twins: float32 max|Δ| ≤ 1e-5·max(1,
max|ref|) (another summation order).
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.core import kernels as jk
from sparkdl_tpu_torch.core import kernels
from sparkdl_tpu_torch.core.model_function import ModelFunction, TensorSpec
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.models import layers

CPU = torch.device("cpu")
EPS = 1e-3


@pytest.fixture(autouse=True)
def _gate(monkeypatch):
    """Engine knobs and the verdict map isolated; no store unless a test
    sets the cache dir itself."""
    saved = EngineConfig.snapshot()
    monkeypatch.delenv(kernels.COMPILE_CACHE_DIR_ENV, raising=False)
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    kernels.reset()
    yield
    kernels.reset()
    EngineConfig.restore(saved)


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setenv(kernels.COMPILE_CACHE_DIR_ENV, str(tmp_path))
    return tmp_path / kernels._VERDICT_STORE_BASENAME


def _site(family="unit"):
    return kernels.Site("pw1x1_relu", family, (2, 4, 4, 8, 8), "float32")


def _inject(site, adopted, device=CPU):
    with kernels._verdict_lock:
        kernels._verdicts[kernels._site_key(site, device)] = {
            "adopted": adopted, "reason": "injected"}


def _operands(b=2, h=4, w=4, cin=8, cout=8, seed=0):
    """NHWC x and port-layout weights, drawn as the JAX package's audition
    draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    gamma = (np.abs(rng.normal(size=cout)) + 0.5).astype(np.float32)
    beta = (rng.normal(size=cout) * 0.1).astype(np.float32)
    mean = (rng.normal(size=cout) * 0.1).astype(np.float32)
    var = (np.abs(rng.normal(size=cout)) + 1.0).astype(np.float32)
    dw = (rng.normal(size=(3, 3, 1, cin)) * 0.2).astype(np.float32)
    pw = (rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin)).astype(
        np.float32)
    return x, dw, pw, gamma, beta, mean, var


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Twins against the JAX package's XLA twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,flag", [("sep2d", False), ("sep2d", True),
                                         ("pw1x1", False), ("pw1x1", True)])
def test_twins_match_xla_twins(kernel, flag):
    x, dw, pw, gamma, beta, mean, var = _operands(2, 7, 9, 16, 24)
    bn = (gamma, beta, mean, var)
    w_pw = _t(pw.transpose(3, 2, 0, 1))
    if kernel == "sep2d":
        ref = jk.xla_sep2d(x, dw, pw, *bn, EPS, relu_in=flag)
        ours = kernels.twin_sep2d(_t(x), _t(dw.transpose(3, 2, 0, 1)), w_pw,
                                  *(_t(a) for a in bn), EPS, relu_in=flag)
    else:
        ref = jk.xla_pw1x1(x, pw, *bn, EPS, relu=flag)
        ours = kernels.twin_pw1x1(_t(x), w_pw, *(_t(a) for a in bn), EPS,
                                  relu=flag)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours.numpy() - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("src,dst", [((13, 17), (29, 23)),
                                     ((40, 36), (32, 32))])
def test_twin_preproc_matches_xla_preproc(src, dst):
    x = np.random.default_rng(1).integers(0, 256, (2, *src, 3), np.uint8)
    ref = np.asarray(jk.xla_preproc(jnp.asarray(x), dst, "float32"))
    ours = kernels.twin_preproc(_t(x), dst, torch.float32)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    err = float(np.abs(ours.numpy() - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), err


# ---------------------------------------------------------------------------
# The verdict store
# ---------------------------------------------------------------------------


def test_verdict_store_roundtrip(store):
    site = _site()
    key = kernels._site_key(site, CPU)
    kernels._persist_verdict(key, {"adopted": True, "reason": "unit"})
    kernels.reset()  # the next lookup must read the file
    assert kernels.verdict_for(site, CPU)["adopted"] is True
    doc = json.loads(store.read_text())
    assert doc["version"] == kernels.VERDICT_STORE_VERSION
    assert key in doc["verdicts"] and key.endswith("|cpu")


def test_verdict_store_merges_entries(store):
    s1 = _site()
    s2 = kernels.Site("sep2d", "unit", (2, 6, 6, 8, 8), "float32")
    kernels._persist_verdict(kernels._site_key(s1, CPU),
                             {"adopted": False, "reason": "slow"})
    kernels._persist_verdict(kernels._site_key(s2, CPU),
                             {"adopted": True, "reason": "fast"})
    kernels.reset()
    assert kernels.verdict_for(s1, CPU)["adopted"] is False
    assert kernels.verdict_for(s2, CPU)["adopted"] is True


def test_verdict_store_corrupt_file_discarded(store):
    store.write_text("{definitely not json")
    assert kernels.verdict_for(_site(), CPU) is None
    kernels._persist_verdict(kernels._site_key(_site(), CPU),
                             {"adopted": False, "reason": "fresh"})
    kernels.reset()
    assert kernels.verdict_for(_site(), CPU)["adopted"] is False
    assert json.loads(store.read_text())["version"] \
        == kernels.VERDICT_STORE_VERSION


def test_verdict_store_stale_version_discarded(store):
    store.write_text(json.dumps(
        {"version": kernels.VERDICT_STORE_VERSION + 1,
         "verdicts": {kernels._site_key(_site(), CPU):
                      {"adopted": True, "reason": "old format"}}}))
    assert kernels.verdict_for(_site(), CPU) is None


def test_verdict_store_malformed_entries_discarded(store):
    good, bad = _site(), _site("bad")
    store.write_text(json.dumps(
        {"version": kernels.VERDICT_STORE_VERSION,
         "verdicts": {kernels._site_key(good, CPU): {"adopted": True},
                      kernels._site_key(bad, CPU): {"adopted": "yes"}}}))
    assert kernels.verdict_for(good, CPU)["adopted"] is True
    assert kernels.verdict_for(bad, CPU) is None


def test_verdicts_stay_in_process_without_cache_dir(tmp_path):
    assert kernels.verdict_store_path() is None
    kernels._persist_verdict(kernels._site_key(_site(), CPU),
                             {"adopted": True, "reason": "unpersisted"})
    kernels.reset()
    assert kernels.verdict_for(_site(), CPU) is None
    assert list(tmp_path.iterdir()) == []


def test_backend_tag_partitions_verdicts(store, monkeypatch):
    """A verdict taken on the CPU or on one card never answers for
    another card: the key ends with the card's name and sm arch."""
    card = {"name": "NVIDIA H100 80GB HBM3", "cc": (9, 0)}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: card["name"])
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=None: card["cc"])
    site, gpu = _site(), torch.device("cuda", 0)
    assert kernels._site_key(site, gpu).endswith(
        "|NVIDIA H100 80GB HBM3 sm_90")
    kernels._persist_verdict(kernels._site_key(site, CPU),
                             {"adopted": True, "reason": "cpu"})
    kernels.reset()
    assert kernels.verdict_for(site, CPU)["adopted"] is True
    assert kernels.verdict_for(site, gpu) is None
    kernels._persist_verdict(kernels._site_key(site, gpu),
                             {"adopted": True, "reason": "h100"})
    card.update(name="NVIDIA H200", cc=(9, 0))
    kernels.reset()
    assert kernels.verdict_for(site, gpu) is None


# ---------------------------------------------------------------------------
# Route gating: off / autotune / force
# ---------------------------------------------------------------------------


def _pw_route(x, relu=True):
    _, _, pw, gamma, beta, mean, var = _operands()
    return kernels.route_pw1x1(x, _t(pw.transpose(3, 2, 0, 1)), _t(gamma),
                               _t(beta), _t(mean), _t(var), EPS, relu=relu,
                               family="unit")


def test_route_returns_none_without_adopted_verdict():
    EngineConfig.pallas_kernels = "autotune"
    assert _pw_route(_t(_operands()[0])) is None


def test_route_honours_injected_verdicts():
    EngineConfig.pallas_kernels = "autotune"
    x = _t(_operands()[0])
    _inject(_site(), adopted=False)
    assert _pw_route(x) is None
    _inject(_site(), adopted=True)
    routed = _pw_route(x)
    EngineConfig.pallas_kernels = "force"
    assert routed is not None and torch.equal(routed, _pw_route(x))
    EngineConfig.pallas_kernels = "off"
    assert _pw_route(x) is None  # off ignores an adopted verdict


def test_force_mode_routes_every_feasible_site():
    EngineConfig.pallas_kernels = "force"
    x, dw, pw, gamma, beta, mean, var = _operands(2, 6, 6, 8, 8)
    bn = [_t(a) for a in (gamma, beta, mean, var)]
    w_dw, w_pw = _t(dw.transpose(3, 2, 0, 1)), _t(pw.transpose(3, 2, 0, 1))
    scale, shift = kernels._fold_bn(*bn, EPS)
    routed = kernels.route_sep2d(_t(x), w_dw, w_pw, *bn, EPS, family="unit")
    assert torch.equal(routed, kernels.plain_sep2d(
        _t(x), w_dw.reshape(8, 9).t().contiguous(),
        w_pw.reshape(8, 8).t().contiguous(), scale, shift))
    img = _t(np.random.default_rng(2).integers(0, 256, (1, 9, 7, 3),
                                               np.uint8))
    assert torch.equal(
        kernels.route_preproc(img, (11, 5), torch.float32, family="unit"),
        kernels.plain_preproc(img, (11, 5), torch.float32))
    assert _pw_route(_t(x).half()) is None  # float16: no kernel takes it
    assert kernels.launches == {"sep2d": 0, "pw1x1": 0, "preproc_resize": 0}


def test_engine_config_knob():
    assert EngineConfig.pallas_kernels == "autotune"  # the default
    EngineConfig.pallas_kernels = "banana"
    with pytest.raises(ValueError, match="pallas_kernels"):
        EngineConfig.validate()
    saved = EngineConfig.snapshot()
    assert saved["pallas_kernels"] == "banana"
    EngineConfig.pallas_kernels = "force"
    EngineConfig.restore(saved)
    assert EngineConfig.pallas_kernels == "banana"


# ---------------------------------------------------------------------------
# Autotune on the CPU: collection, clean rejections, identical features
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xception():
    from sparkdl_tpu_torch.models.registry import build_featurizer

    return build_featurizer("Xception", weights="random", seed=3)


#: (Cin, Cout) of the sep2d sites at 75×75 and their spatial size.
_XCEPTION_75 = [(35, 64, 128), (35, 128, 128), (18, 128, 256),
                (18, 256, 256), (9, 256, 728), (9, 728, 728), (5, 728, 728),
                (5, 728, 1024), (3, 1024, 1536), (3, 1536, 2048)]


def test_cpu_autotune_rejects_cleanly_and_equals_off(xception):
    x = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), np.uint8)
    EngineConfig.pallas_kernels = "off"
    off = xception.apply_batch(x, batch_size=2, device="cpu")
    assert kernels.verdicts_snapshot() == {}
    EngineConfig.pallas_kernels = "autotune"
    auto = xception.apply_batch(x, batch_size=2, device="cpu")
    snap = kernels.verdicts_snapshot()
    assert len(snap) == len(_XCEPTION_75)
    assert all(v["adopted"] is False and "no CUDA device" in v["reason"]
               for v in snap.values()), snap
    assert auto.dtype == off.dtype
    np.testing.assert_array_equal(auto, off)


def test_first_launch_settles_the_expected_sites(xception, store):
    """A resized Xception's first chunk settles one verdict per distinct
    site (the preproc resize and the ten sep2d shapes at batch 2), and
    a later chunk of the same shape settles nothing more."""
    EngineConfig.pallas_kernels = "autotune"
    mf = xception.resized((40, 48), (75, 75))
    x = np.random.default_rng(5).integers(0, 256, (4, 40, 48, 3), np.uint8)
    mf.apply_batch(x, batch_size=2, device="cpu")
    want = {f"sep2d|xception|2x{s}x{s}x{i}x{o}|float32|cpu"
            for s, i, o in _XCEPTION_75}
    want.add("preproc|Xception_featurize|2x40x48x3x75x75|float32->float32"
             "|cpu")
    assert set(kernels.verdicts_snapshot()) == want
    assert set(json.loads(store.read_text())["verdicts"]) == want
    sites = kernels.collect_sites(mf, torch.empty(2, 40, 48, 3),
                                  mf.variables)
    assert sum(sites.values()) == 35  # 34 sep2d calls + the resize


def test_ensure_autotuned_is_a_noop_outside_autotune(xception):
    x = torch.zeros(2, 75, 75, 3)
    for mode in ("off", "force"):
        EngineConfig.pallas_kernels = mode
        assert not kernels.ensure_autotuned(xception, x,
                                            variables=xception.variables)
    assert kernels.verdicts_snapshot() == {}


def test_collection_raises_when_the_meta_pass_fails():
    """An op with no meta version (here ``.item()``) makes the meta pass
    fail; the collection raises rather than run a real forward, and
    leaves no collection scope behind."""

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.unit = layers.ConvBN(3, 8, 1, kernel_family="tiny")

        def forward(self, x):
            assert x.sum().item() == 0.0
            return self.unit(x)

    module = Tiny().eval()
    with pytest.raises((NotImplementedError, RuntimeError)):
        kernels.collect_sites(module, torch.ones(2, 4, 4, 3), module)
    assert kernels._collecting() is None


def test_kernel_routable_rides_along_the_wrappers():
    spec = TensorSpec((None, 4, 4, 3))
    routable = ModelFunction.fromModule(torch.nn.Identity(), spec)
    plain = ModelFunction.fromFunction(lambda vs, x: x, None, spec)
    assert routable.kernel_routable and not plain.kernel_routable
    for wrapped in (routable.with_preprocess(lambda x: x),
                    routable.with_postprocess(lambda y: y),
                    routable.flattened(), plain.resized((2, 2))):
        assert wrapped.kernel_routable
    assert not plain.flattened().kernel_routable
    # the reference's with_compute_dtype drops the flag: bf16 never
    # auditions
    assert not routable.with_dtype("bfloat16").kernel_routable


@pytest.mark.parametrize("wrap", ["bare", "flattened", "resized"])
def test_bf16_variant_is_not_kernel_routable_in_either_package(wrap):
    """The same one-unit model in both packages: routable in float32,
    not routable once ``with_dtype("bfloat16")`` wraps it, in the
    reference and in the port alike."""
    from sparkdl_tpu.core.model_function import ModelFunction as JaxMF
    from sparkdl_tpu.core.model_function import TensorSpec as JaxSpec
    from sparkdl_tpu.models.layers import SeparableConvBN as JaxSep
    from sparkdl_tpu_torch.models.convert import from_flax_variables
    from tests.torch_port_helpers import random_variables

    cin, cout = 3, 8
    jm = JaxSep(cout, kernel_family="xception")
    vs = random_variables(jm, (1, 6, 6, cin), seed=6)
    tm = layers.SeparableConvBN(cin, cout, kernel_family="xception")
    tm.load_state_dict(from_flax_variables("sep", vs))
    models = [JaxMF.fromFlax(jm, vs, JaxSpec((None, 6, 6, cin)),
                             train=False),
              ModelFunction.fromModule(tm.eval(), TensorSpec((None, 6, 6,
                                                              cin)))]
    for mf in models:
        if wrap == "flattened":
            mf = mf.flattened()
        elif wrap == "resized":
            mf = mf.resized((4, 5))
        assert mf.kernel_routable, (type(mf).__module__, wrap)
        assert not mf.with_dtype("bfloat16").kernel_routable, \
            (type(mf).__module__, wrap)


def test_bf16_featurize_under_autotune_records_no_verdict(xception):
    """The default precision (bf16) under the default gate ("autotune")
    collects, auditions and routes nothing, as in the reference; float32
    settles every site."""
    from sparkdl_tpu_torch.core import executor

    x = np.random.default_rng(4).integers(0, 256, (2, 75, 75, 3), np.uint8)
    EngineConfig.pallas_kernels = "autotune"
    EngineConfig.inference_precision = "bfloat16"
    feats = executor.execute(xception, x, batch_size=2)
    assert feats.shape == (2, 2048) and np.isfinite(feats).all()
    assert kernels.verdicts_snapshot() == {}
    assert kernels.launches["sep2d"] == 0
    # float32 at a shape no other test has shown this model
    EngineConfig.inference_precision = "float32"
    executor.execute(xception, x[:, :71, :71], batch_size=2)
    snap = kernels.verdicts_snapshot()
    assert snap and all(k.startswith("sep2d|") and "|float32|cpu" in k
                        for k in snap), snap


# ---------------------------------------------------------------------------
# The decision, with the backend check and the timer monkeypatched
# ---------------------------------------------------------------------------


def _fake_card(monkeypatch, kernel_out, twin_out, kernel_s, twin_s):
    """The CPU poses as a card: a shootout returning fixed outputs, and a
    timer returning fixed times."""
    x = torch.zeros(1)

    def kernel_fn(a):
        return kernel_out

    def twin_fn(a):
        return twin_out

    monkeypatch.setattr(kernels, "_backend_supported", lambda device: True)
    monkeypatch.setattr(kernels, "_build_shootout",
                        lambda site, device: (kernel_fn, twin_fn, x))
    times = {kernel_fn: kernel_s, twin_fn: twin_s}
    monkeypatch.setattr(kernels, "_time_calls", lambda fn, a: times[fn])


@pytest.mark.parametrize("dtype,delta,kernel_s,adopted,reason", [
    ("float32", 0.0, 0.90, True, "speedup"),
    ("float32", 0.0, 0.96, False, "not faster"),
    ("float32", "ulp", 0.50, False, "numeric contract"),
    ("bfloat16", 0.03125, 0.90, True, "speedup"),
    ("bfloat16", 0.0625, 0.90, False, "numeric contract"),
])
def test_audition_decides(monkeypatch, dtype, delta, kernel_s, adopted,
                          reason):
    twin = torch.linspace(-2, 2, 64, dtype=getattr(torch, dtype))
    kernel = twin.clone()
    if delta == "ulp":
        kernel[7] = torch.nextafter(kernel[7], torch.tensor(np.inf))
    else:
        kernel[7] += delta
    _fake_card(monkeypatch, kernel, twin, kernel_s, 1.0)
    verdict = kernels.ensure_verdict(_site(), CPU)
    assert verdict["adopted"] is adopted and reason in verdict["reason"]
    assert verdict["kernel_s"] == kernel_s and verdict["twin_s"] == 1.0
    assert verdict["max_abs_err"] > 0.0 or delta == 0.0
    assert kernels.verdict_for(_site(), CPU) == verdict


def test_failing_candidate_raises_out_of_ensure_verdict(monkeypatch):
    """On the card no failure becomes a rejection: the error reaches the
    caller and nothing is recorded, so the site is tried again."""
    _fake_card(monkeypatch, None, torch.zeros(4), 0.5, 1.0)

    def broken(site, device):
        def kernel_fn(a):
            raise RuntimeError("pw1x1 kernel launch failed: CUDA error 9")
        return kernel_fn, lambda a: torch.zeros(4), torch.zeros(1)

    monkeypatch.setattr(kernels, "_build_shootout", broken)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        kernels.ensure_verdict(_site(), CPU)
    assert kernels.verdict_for(_site(), CPU) is None
    assert kernels._inflight == {}


def test_two_threads_audition_one_site_once(monkeypatch):
    calls = []

    def slow_audition(site, device):
        calls.append(site)
        time.sleep(0.2)
        return {"adopted": False, "reason": "slow"}

    monkeypatch.setattr(kernels, "_audition", slow_audition)
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(kernels.ensure_verdict(_site(), CPU)))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert got == [{"adopted": False, "reason": "slow"}] * 2
