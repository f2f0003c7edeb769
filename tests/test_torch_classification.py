"""The classifier of the flagship workflow against the JAX package.

``ml/lbfgs.py`` is held to ``optax.lbfgs()`` (the reference's solver)
over its first 3 iterates, on a quadratic and on the softmax loss, within
``1e-4·max(1, max|ref|)``. ``LogisticRegression`` is held to the
reference's on the same numpy data (3 classes, d = 16, n = 96, seeded):
coefficients, intercepts and probabilities within float32's
``1e-3·max|ref|``, predictions equal, and ``numIterations`` within 5 of
the reference's (the two float32 loops agree iterate by iterate, but
where the gradient norm sinks to ``tol = 1e-6`` only at float32's floor
the last few iterations can differ). The reference's error paths raise
in the port too. Everything runs on the CPU (``EngineConfig.device =
"cpu"``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.ml.classification import LogisticRegression as JaxLR
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.ml import lbfgs
from sparkdl_tpu_torch.ml.classification import (
    LogisticRegression, LogisticRegressionModel, SoftmaxObjective,
)

N, D, K = 96, 16, 3
F32_REL = 1e-3
LBFGS_REL = 1e-4
ITER_SLACK = 5


@pytest.fixture(autouse=True)
def cpu_engine():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    yield
    EngineConfig.restore(saved)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    y = rng.integers(0, K, N)
    centers = rng.normal(size=(K, D)) * 1.5
    x = (centers[y] + rng.normal(size=(N, D))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    return x, y, w


def _frames(x, y, w, parts=3):
    rows = [{"features": x[i].tolist(), "label": int(y[i]),
             "w": float(w[i])} for i in range(len(x))]
    ref = sparkdl_tpu.DataFrame.fromRows(rows, numPartitions=parts)
    ours = sparkdl_tpu_torch.DataFrame.fromColumns(
        {"features": x, "label": y.tolist(), "w": w.tolist()},
        numPartitions=parts)
    return ref, ours


def _optax_iterates(f, x0, k):
    """The reference's loop body, k times, as one jitted step."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=f)
        return optax.apply_updates(x, updates), state

    x, state, out = x0, opt.init(x0), []
    for _ in range(k):
        x, state = step(x, state)
        out.append(np.asarray(x))
    return out


def _our_iterates(value_and_grad, x0, k):
    out = []
    lbfgs.minimize(value_and_grad, x0, max_iter=k, tol=0.0,
                   callback=lambda i, x: out.append(x.numpy().copy()))
    return out


def _assert_iterates(ref, ours):
    assert len(ours) == len(ref)
    for r, o in zip(ref, ours):
        limit = LBFGS_REL * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(r - o).max()) <= limit


def test_lbfgs_matches_optax_on_a_quadratic():
    rng = np.random.default_rng(11)
    m = rng.normal(size=(12, 12)).astype(np.float32)
    a = (m @ m.T / 12 + 0.1 * np.eye(12)).astype(np.float32)
    c = rng.normal(size=12).astype(np.float32)
    at, ct = torch.from_numpy(a), torch.from_numpy(c)

    def ours(x):
        ax = at @ x
        return 0.5 * x @ ax - ct @ x, ax - ct

    ref = _optax_iterates(lambda x: 0.5 * x @ (a @ x) - c @ x,
                          jnp.zeros(12), 3)
    _assert_iterates(ref, _our_iterates(ours, torch.zeros(12), 3))


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_lbfgs_matches_optax_on_the_softmax_loss(data, fit_intercept):
    x, y, _ = data
    reg = 0.05

    def loss(p):
        w = p[:D * K].reshape(D, K)
        logits = x @ w + (p[D * K:] if fit_intercept else 0.0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean() + 0.5 * reg * jnp.sum(w ** 2)

    objective = SoftmaxObjective(torch.from_numpy(x), torch.from_numpy(y),
                                 K, reg, fit_intercept)
    p0 = np.zeros(D * K + K, np.float32)
    v_ref, g_ref = jax.value_and_grad(loss)(jnp.asarray(p0))
    v, g = objective(torch.from_numpy(p0))
    assert abs(float(v) - float(v_ref)) <= 1e-6 * abs(float(v_ref))
    assert np.abs(g.numpy() - np.asarray(g_ref)).max() <= 1e-6
    ref = _optax_iterates(loss, jnp.asarray(p0), 3)
    _assert_iterates(ref, _our_iterates(objective, torch.from_numpy(p0), 3))


def test_line_search_steps_match_optax_down_to_float32s_floor():
    """On a near-separable fit (24 rows, 256 standardized features) the
    zoom line search takes optax's number of steps in each of the first
    25 iterations; once the objective reaches float32's floor both run
    out their 20 steps in some iterations and end at the same objective
    within 1e-5 relative."""
    rng = np.random.default_rng(0)
    n, d, k, reg = 24, 256, 2, 0.01
    y = np.arange(n) % 2
    x = np.maximum(rng.normal(size=(n, d))
                   + 0.5 * y[:, None] * rng.normal(size=(1, d)), 0)
    x = (x / x.std(axis=0, ddof=1)).astype(np.float32)

    def loss(p):
        logits = x @ p[:d * k].reshape(d, k) + p[d * k:]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean() + 0.5 * reg * jnp.sum(p[:d * k] ** 2)

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(p, state):
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad,
                                    value_fn=loss)
        return (optax.apply_updates(p, updates), state,
                state[-1].info.num_linesearch_steps)

    p, state, ref_steps = jnp.zeros(d * k + k), opt.init(
        jnp.zeros(d * k + k)), []
    for _ in range(60):
        p, state, steps = step(p, state)
        ref_steps.append(int(steps))
    objective = SoftmaxObjective(torch.from_numpy(x), torch.from_numpy(y),
                                 k, reg, True)
    ours = lbfgs.minimize(objective, torch.zeros(d * k + k), max_iter=60,
                          tol=0.0)
    assert ours.steps_per_iteration[:25] == ref_steps[:25]
    assert 20 in ours.steps_per_iteration and 20 in ref_steps
    ref_value = float(loss(p))
    assert abs(float(objective(ours.x)[0]) - ref_value) \
        <= 1e-5 * ref_value


def test_lbfgs_loop_counts_its_syncs_and_stops_one_past_tol():
    """The loop condition reads the gradient carried from the step
    before (the reference's carry), so after the gradient first falls to
    ``tol`` one more iteration runs; the host reads the flags once
    before the loop and once per line-search step."""
    scale = torch.tensor([1.0, 4.0, 9.0])

    def quad(x):
        return 0.5 * (scale * x * x).sum(), scale * x

    res = lbfgs.minimize(quad, torch.tensor([1.0, 1.0, 1.0]), max_iter=50,
                         tol=1e-3)
    assert res.syncs == 1 + res.linesearch_steps
    assert len(res.steps_per_iteration) == res.iterations
    assert res.evaluations >= 1 + res.linesearch_steps
    norms = []
    lbfgs.minimize(quad, torch.tensor([1.0, 1.0, 1.0]), max_iter=50,
                   tol=1e-3,
                   callback=lambda i, x: norms.append(
                       float(torch.linalg.vector_norm(scale * x))))
    first_below = next(i for i, n in enumerate(norms) if n <= 1e-3)
    assert res.iterations == first_below + 2
    none = lbfgs.minimize(quad, torch.zeros(3), max_iter=50, tol=1e-3)
    assert none.iterations == 0 and none.syncs == 1


CASES = [dict(regParam=r, standardization=s, fitIntercept=i)
         for r in (0.01, 0.1) for s in (True, False) for i in (True, False)]
CASES += [dict(regParam=0.01, weightCol="w"),
          dict(regParam=0.1, standardization=False, weightCol="w"),
          dict(regParam=0.01, thresholds=[0.5, 1.0, 2.0]),
          dict(regParam=0.1, fitIntercept=False, thresholds=[2.0, 1.0, 1.0])]


@pytest.mark.parametrize("params", CASES,
                         ids=[str(sorted(c.items())) for c in CASES])
def test_logistic_regression_matches_reference(data, params):
    x, y, w = data
    ref_df, our_df = _frames(x, y, w)
    ref = JaxLR(maxIter=100, **params).fit(ref_df)
    ours = LogisticRegression(maxIter=100, **params).fit(our_df)
    wlim = F32_REL * float(np.abs(ref.coefficients).max())
    assert float(np.abs(ours.coefficients - ref.coefficients).max()) <= wlim
    if params.get("fitIntercept", True):
        blim = F32_REL * float(np.abs(ref.intercept).max())
        assert float(np.abs(ours.intercept - ref.intercept).max()) <= blim
    else:
        assert not ours.intercept.any() and not ref.intercept.any()
    assert abs(ours.numIterations - ref.numIterations) <= ITER_SLACK
    ref_rows = ref.transform(ref_df).collect()
    our_rows = ours.transform(our_df).collect()
    rp = np.array([r["probability"] for r in ref_rows], np.float32)
    op = np.array([r["probability"] for r in our_rows], np.float32)
    assert float(np.abs(op - rp).max()) <= F32_REL * float(np.abs(rp).max())
    assert [r["prediction"] for r in our_rows] \
        == [r["prediction"] for r in ref_rows]
    stats = ours.fitStats
    assert stats["device"] == "cpu" and stats["rows"] == N
    assert stats["syncs"] == 1 + stats["linesearch_steps"]
    assert stats["iterations"] == ours.numIterations


def test_transform_keeps_null_rows_null(data):
    x, y, w = data
    _, our_df = _frames(x, y, w)
    model = LogisticRegression(maxIter=20).fit(our_df)
    feats = [x[0], None, x[2], None]
    frame = sparkdl_tpu_torch.DataFrame.fromColumns(
        {"features": feats, "label": [0, 1, 2, 0]})
    rows = model.transform(frame).collect()
    ref_model = sparkdl_tpu.ml.LogisticRegressionModel()
    ref_model._set_weights(model.coefficients, model.intercept)
    ref_rows = ref_model.transform(sparkdl_tpu.DataFrame.fromRows(
        [{"features": None if f is None else f.tolist(), "label": 0}
         for f in feats])).collect()
    assert [r["prediction"] for r in rows] \
        == [r["prediction"] for r in ref_rows]
    assert rows[1]["probability"] is None and rows[3]["probability"] is None
    np.testing.assert_allclose(rows[0]["probability"],
                               ref_rows[0]["probability"], rtol=1e-6)


def test_fit_skips_null_feature_rows_as_the_reference(data):
    x, y, _ = data
    feats = [None if i % 7 == 0 else x[i] for i in range(N)]
    ours = LogisticRegression(maxIter=30, regParam=0.1).fit(
        sparkdl_tpu_torch.DataFrame.fromColumns(
            {"features": feats, "label": y.tolist()}, numPartitions=2))
    ref = JaxLR(maxIter=30, regParam=0.1).fit(
        sparkdl_tpu.DataFrame.fromRows(
            [{"features": None if f is None else f.tolist(),
              "label": int(y[i])} for i, f in enumerate(feats)]))
    lim = F32_REL * float(np.abs(ref.coefficients).max())
    assert float(np.abs(ours.coefficients - ref.coefficients).max()) <= lim
    assert ours.fitStats["rows"] == sum(f is not None for f in feats)


def _raise_in_both(make_rows, exc, **params):
    rows = make_rows()
    with pytest.raises(exc) as ref_err:
        JaxLR(**params).fit(sparkdl_tpu.DataFrame.fromRows(rows))
    names = list(rows[0])
    with pytest.raises(exc) as our_err:
        LogisticRegression(**params).fit(
            sparkdl_tpu_torch.DataFrame.fromColumns(
                {n: [r[n] for r in rows] for n in names}))
    return str(ref_err.value), str(our_err.value)


@pytest.mark.parametrize("case", ["no_rows", "string_labels",
                                  "negative_labels", "bad_thresholds",
                                  "negative_weights"])
def test_error_paths_raise_as_the_reference(case):
    good = lambda: [{"features": [0.0, 1.0], "label": i % 2, "w": 1.0}  # noqa
                    for i in range(4)]
    if case == "no_rows":
        ref, ours = _raise_in_both(
            lambda: [{"features": None, "label": 0}], ValueError)
    elif case == "string_labels":
        ref, ours = _raise_in_both(
            lambda: [{"features": [0.0], "label": "cat"}], ValueError)
    elif case == "negative_labels":
        ref, ours = _raise_in_both(
            lambda: [{"features": [0.0], "label": -1},
                     {"features": [1.0], "label": 1}], ValueError)
    elif case == "bad_thresholds":
        ref, ours = _raise_in_both(good, ValueError, thresholds=[1.0])
    else:
        ref, ours = _raise_in_both(
            lambda: [dict(r, w=-1.0) for r in good()], ValueError,
            weightCol="w")
    assert ours == ref


def test_unsupported_params_raise_in_both():
    with pytest.raises(TypeError):
        JaxLR(elasticNetParam=0.5)
    with pytest.raises(TypeError):
        LogisticRegression(elasticNetParam=0.5)
    with pytest.raises(TypeError):
        LogisticRegression(maxIter="ten")


def test_fit_on_the_default_device_without_a_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    x, y, w = data
    EngineConfig.device = "cuda"
    _, our_df = _frames(x, y, w)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LogisticRegression(maxIter=5).fit(our_df)


def test_transform_and_evaluators_under_eight_threads(data):
    """The model's scoring and the evaluators run on partition threads:
    8 threads over 16 partitions give the rows and values of one
    thread."""
    x, y, w = data
    _, our_df = _frames(x, y, w, parts=16)
    model = LogisticRegression(maxIter=30, regParam=0.1).fit(our_df)
    evaluators = [sparkdl_tpu_torch.MulticlassClassificationEvaluator(
        metricName=m) for m in ("f1", "accuracy")]
    evaluators.append(sparkdl_tpu_torch.RegressionEvaluator())
    EngineConfig.max_workers = 1
    one = model.transform(our_df).collect()
    one_vals = [e.evaluate(model.transform(our_df)) for e in evaluators]
    EngineConfig.max_workers = 8
    names = set()
    scored = model.transform(our_df)
    threads = [threading.Thread(target=lambda: names.add(len(
        scored.collect()))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    many = model.transform(our_df).collect()
    assert names == {N}
    assert [r["prediction"] for r in many] == [r["prediction"] for r in one]
    assert all(np.array_equal(a["probability"], b["probability"])
               for a, b in zip(many, one))
    assert [e.evaluate(model.transform(our_df)) for e in evaluators] \
        == one_vals


def test_model_params_surface():
    model = LogisticRegressionModel(predictionCol="p", thresholds=[1, 2])
    assert model.getPredictionCol() == "p" and model.getThresholds() == [1, 2]
    lr = LogisticRegression().setMaxIter(7).setRegParam(1).setTol(1e-3)
    assert (lr.getMaxIter(), lr.getRegParam(), lr.getTol()) == (7, 1.0, 1e-3)
    assert lr.getWeightCol() is None and lr.getThresholds() is None
    assert {p.name for p in lr.params} == {p.name for p in JaxLR().params}
