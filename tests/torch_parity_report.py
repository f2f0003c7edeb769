"""Print the port's measured parity against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

The same comparisons the ``tests/test_torch_*.py`` files assert, with the
measured max|Δ| printed as JSON lines (``PERF.md`` quotes them): the
plain kernel versions against the Pallas kernels (interpret mode) and
their XLA twins, the plain probes against the Pallas probes, the kernel
gate's twins against the XLA twins, Xception and InceptionV3 (module and
fast path) at 75×75, and the featurize slices at 299×299 (in ``"force"``,
as the tests run them). Last, the gate's bf16 contract at real site
shapes: how far the bf16 twin lies from the plain version (the kernel's
arithmetic, rounded once), on the audition's own operands.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests import test_torch_kernels as kt  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    column, frames, headless, max_abs, random_variables,
)


def kernels_report():
    b, h, w, cin, cout = 2, 7, 9, 16, 24
    for dtype in ("float32", "bfloat16"):
        for relu_in in (False, True):
            x, dw, pw, gamma, beta, mean, var = kt._sep2d_operands(
                b, h, w, cin, cout)
            jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
            xj, dwj, pwj = (jnp.asarray(a, jdt) for a in (x, dw, pw))
            scale, shift = kt.jk._fold_bn(*(jnp.asarray(a) for a in
                                            (gamma, beta, mean, var)),
                                          kt.EPS, cout)
            pallas = kt.jk.sep2d(xj, dwj.reshape(9, cin),
                                 pwj.reshape(cin, cout), scale, shift,
                                 relu_in=relu_in, interpret=True)
            twin = kt.jk.xla_sep2d(xj, dwj, pwj, *(jnp.asarray(a, jdt) for a
                                                   in (gamma, beta, mean,
                                                       var)),
                                   kt.EPS, relu_in=relu_in)
            ours = kt.tk.plain_sep2d(
                kt._t(xj, tdt), kt._t(dwj.reshape(9, cin), tdt),
                kt._t(pwj.reshape(cin, cout), tdt),
                torch.from_numpy(np.array(scale)),
                torch.from_numpy(np.array(shift)), relu_in=relu_in)
            print(json.dumps({
                "check": "plain_sep2d", "dtype": dtype, "relu_in": relu_in,
                "vs_pallas": max_abs(kt._np32(ours), kt._np32(pallas)),
                "vs_xla": max_abs(kt._np32(ours), kt._np32(twin)),
                "max_abs_ref": float(np.abs(kt._np32(twin)).max())}))
    b, h, w = 2, 5, 7
    for dtype in ("float32", "bfloat16"):
        for relu in (False, True):
            x, _, pw, gamma, beta, mean, var = kt._sep2d_operands(
                b, h, w, cin, cout)
            jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
            xj, pwj = jnp.asarray(x, jdt), jnp.asarray(pw, jdt)
            scale, shift = kt.jk._fold_bn(*(jnp.asarray(a) for a in
                                            (gamma, beta, mean, var)),
                                          kt.EPS, cout)
            pallas = kt.jk.pw1x1(xj, pwj.reshape(cin, cout), scale, shift,
                                 relu=relu, interpret=True)
            twin = kt.jk.xla_pw1x1(xj, pwj, *(jnp.asarray(a, jdt) for a in
                                              (gamma, beta, mean, var)),
                                   kt.EPS, relu=relu)
            ours = kt.tk.plain_pw1x1(
                kt._t(xj, tdt), kt._t(pwj.reshape(cin, cout), tdt),
                torch.from_numpy(np.array(scale)),
                torch.from_numpy(np.array(shift)), relu=relu)
            print(json.dumps({
                "check": "plain_pw1x1", "dtype": dtype, "relu": relu,
                "vs_pallas": max_abs(kt._np32(ours), kt._np32(pallas)),
                "vs_xla": max_abs(kt._np32(ours), kt._np32(twin)),
                "max_abs_ref": float(np.abs(kt._np32(twin)).max())}))
    rng = np.random.default_rng(1)
    for src, dst in (((13, 17), (29, 23)), ((40, 36), (32, 32))):
        x = rng.integers(0, 256, size=(2, *src, 3)).astype(np.uint8)
        for out in ("float32", "bfloat16"):
            ours = kt._np32(kt.tk.plain_preproc(torch.from_numpy(x), dst,
                                                getattr(torch, out)))
            print(json.dumps({
                "check": "plain_preproc", "src": src, "dst": dst,
                "out": out,
                "vs_pallas": max_abs(ours, kt._np32(kt.jk.preproc_resize(
                    jnp.asarray(x), dst, out, interpret=True))),
                "vs_xla": max_abs(ours, kt._np32(kt.jk.xla_preproc(
                    jnp.asarray(x), dst, out)))}))


def probes_report():
    from jax.experimental.pallas import tpu as pltpu

    import experiments.pallas_probe as jp
    from tests import test_torch_probe as pt

    inputs = pt.inputs.__wrapped__()
    jp.GRID = 1
    x2 = jp.pad_rows(inputs["x"])
    for name, extra in (("fma9", ()), ("dw2d", ()),
                        ("sep2d_probe", ("pw", "sc", "sh"))):
        args = [inputs["k9"]] + [inputs[k] for k in extra]
        with pltpu.force_tpu_interpret_mode():
            ref = getattr(jp, "sep2d" if name == "sep2d_probe" else name)(
                pt._jax(x2), *(pt._jax(a) for a in args))
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        ours = getattr(pt.tp, f"plain_{name}")(
            pt._torch(x2), *(pt._torch(a) for a in args)).float().numpy()
        print(json.dumps({"check": f"plain_{name}_vs_pallas_all_rows",
                          "max_abs": max_abs(ours, ref),
                          "max_abs_ref": float(np.abs(ref).max())}))


def twins_report():
    from tests import test_torch_autotune as at

    x, dw, pw, gamma, beta, mean, var = at._operands(2, 7, 9, 16, 24)
    bn = (gamma, beta, mean, var)
    w_pw = at._t(pw.transpose(3, 2, 0, 1))
    ref = np.asarray(kt.jk.xla_sep2d(x, dw, pw, *bn, at.EPS))
    ours = kt.tk.twin_sep2d(at._t(x), at._t(dw.transpose(3, 2, 0, 1)), w_pw,
                            *(at._t(a) for a in bn), at.EPS).numpy()
    print(json.dumps({"check": "twin_sep2d_vs_xla_f32",
                      "max_abs": max_abs(ours, ref),
                      "max_abs_ref": float(np.abs(ref).max())}))
    ref = np.asarray(kt.jk.xla_pw1x1(x, pw, *bn, at.EPS, relu=True))
    ours = kt.tk.twin_pw1x1(at._t(x), w_pw, *(at._t(a) for a in bn), at.EPS,
                            relu=True).numpy()
    print(json.dumps({"check": "twin_pw1x1_vs_xla_f32",
                      "max_abs": max_abs(ours, ref),
                      "max_abs_ref": float(np.abs(ref).max())}))
    img = np.random.default_rng(1).integers(0, 256, (2, 40, 36, 3), np.uint8)
    ref = np.asarray(kt.jk.xla_preproc(jnp.asarray(img), (32, 32),
                                       "float32"))
    ours = kt.tk.twin_preproc(torch.from_numpy(img), (32, 32),
                              torch.float32).numpy()
    print(json.dumps({"check": "twin_preproc_vs_xla_f32",
                      "max_abs": max_abs(ours, ref),
                      "max_abs_ref": float(np.abs(ref).max())}))


def gate_contract_report():
    """bf16 sites of the card's autotune phases, on the audition's
    operands (both packages draw the same ones): max|plain − twin| for
    the port's twin and for the JAX package's XLA twin (jitted on the
    CPU), against the contract's 0.05."""
    tk, jk = kt.tk, kt.jk
    for site in (tk.Site("sep2d", "xception", (16, 19, 19, 728, 728),
                         "bfloat16"),
                 tk.Site("pw1x1_relu", "inception", (16, 35, 35, 192, 64),
                         "bfloat16"),
                 tk.Site("pw1x1_relu", "inception", (16, 17, 17, 768, 192),
                         "bfloat16")):
        kernel_fn, twin_fn, x = tk._build_shootout(site, torch.device("cpu"))
        with torch.inference_mode():
            plain, twin = kernel_fn(x).float(), twin_fn(x).float()
        _, xla_fn, xj = jk._build_shootout(jk.Site(site.kernel, site.family,
                                                   site.shape, site.dtype))
        xla = np.asarray(jnp.asarray(jax.jit(xla_fn)(xj), jnp.float32))
        print(json.dumps({"check": "bf16_contract_plain_vs_twin",
                          "site": tk._site_key(site, "cpu"),
                          "max_abs": float((plain - twin).abs().max()),
                          "max_abs_vs_xla_twin": max_abs(plain.numpy(), xla),
                          "max_abs_twin": float(twin.abs().max()),
                          "contract": tk.BF16_TOLERANCE}))


def xception_report():
    from sparkdl_tpu.models.xception import Xception as JaxXception
    from sparkdl_tpu_torch.models.convert import from_flax_variables
    from sparkdl_tpu_torch.models.xception import Xception

    jm = JaxXception(include_top=False, pooling="avg")
    vs = headless(random_variables(JaxXception(include_top=True),
                                   (1, 75, 75, 3), seed=0))
    x = np.random.default_rng(5).normal(size=(2, 75, 75, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(vs, x))
    tm = Xception(include_top=False)
    tm.load_state_dict(from_flax_variables("Xception", vs))
    with torch.inference_mode():
        ours = tm.eval()(torch.from_numpy(x)).numpy()
    print(json.dumps({"check": "xception_75x75_f32",
                      "max_abs": max_abs(ours, ref),
                      "max_abs_ref": float(np.abs(ref).max())}))


def inception_report():
    from sparkdl_tpu.models.inception import InceptionV3 as JaxInceptionV3
    from sparkdl_tpu.models.inception_fast import (
        inception_v3_fast_apply as jax_fast,
    )
    from sparkdl_tpu_torch.models.convert import from_flax_variables
    from sparkdl_tpu_torch.models.inception import InceptionV3
    from sparkdl_tpu_torch.models.inception_fast import (
        inception_v3_fast_apply,
    )

    vs = headless(random_variables(JaxInceptionV3(include_top=True),
                                   (1, 75, 75, 3), seed=21))
    x = np.random.default_rng(22).uniform(-1.0, 1.0, size=(2, 75, 75, 3)
                                          ).astype(np.float32)
    ref = np.asarray(jax.jit(JaxInceptionV3(include_top=False).apply)(vs, x))
    ref_fast = np.asarray(jax.jit(lambda v, x: jax_fast(
        v, x, compute_dtype=jnp.float32))(vs, x))
    tm = InceptionV3(include_top=False)
    tm.load_state_dict(from_flax_variables("InceptionV3", vs))
    with torch.inference_mode():
        ours = tm.eval()(torch.from_numpy(x)).numpy()
        fast = inception_v3_fast_apply(tm, torch.from_numpy(x),
                                       compute_dtype=torch.float32).numpy()
    print(json.dumps({"check": "inception_module_75x75_f32",
                      "max_abs": max_abs(ours, ref),
                      "max_abs_ref": float(np.abs(ref).max())}))
    print(json.dumps({"check": "inception_fast_75x75_f32",
                      "max_abs": max_abs(fast, ref_fast),
                      "max_abs_ref": float(np.abs(ref_fast).max())}))


def slice_report():
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.engine.dataframe import EngineConfig as JaxConfig
    from sparkdl_tpu_torch.engine.dataframe import EngineConfig

    JaxConfig.inference_precision = "float32"
    EngineConfig.device, EngineConfig.inference_precision = "cpu", "float32"
    EngineConfig.pallas_kernels = "force"
    from sparkdl_tpu.models.inception import InceptionV3 as JaxInceptionV3
    from sparkdl_tpu.models.xception import Xception as JaxXception

    for name, module, seed, n, size in (
            ("Xception", JaxXception, 11, 3, (64, 80)),
            ("InceptionV3", JaxInceptionV3, 21, 2, (40, 48))):
        vs = headless(random_variables(module(include_top=True),
                                       (1, 75, 75, 3), seed=seed))
        rng = np.random.default_rng(seed + 1 if name == "Xception" else 28)
        images = [rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
                  for _ in range(n)]
        jdf, tdf = frames(images, [str(i) for i in range(n)])
        kw = dict(inputCol="image", outputCol="features", modelName=name,
                  weights=vs, batchSize=n)
        ref = column(sparkdl_tpu.DeepImageFeaturizer(**kw), jdf, "features")
        ours = column(sparkdl_tpu_torch.DeepImageFeaturizer(**kw), tdf,
                      "features")
        print(json.dumps({"check": f"featurizer_{name}_{size[0]}x{size[1]}"
                                   "_to_299_f32",
                          "max_abs": max_abs(ours, ref),
                          "max_abs_ref": float(np.abs(ref).max())}))


if __name__ == "__main__":
    kernels_report()
    probes_report()
    twins_report()
    gate_contract_report()
    xception_report()
    inception_report()
    slice_report()
