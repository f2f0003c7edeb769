"""The SQL surface against the JAX package: ``engine/sql_expr.py`` (the
port's copy) parses and evaluates a table of expressions as the
reference's, NULL rows included; ``where``, ``selectExpr``, ``sql``,
``table``, ``filter``, ``dropna``, ``limit`` and the column renames give
the reference's rows; ``randomSplit`` puts the same rows in each split
for a seed; and a model served with ``registerImageUDF`` through ``sql``
gives the rows of a direct transform, and the reference's features
within float32's ``1e-3·max|ref|``. The temp views and the UDF registry
are process-wide: each test clears both. CPU only.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import sparkdl_tpu
import sparkdl_tpu_torch
from sparkdl_tpu.engine import dataframe as jax_dataframe
from sparkdl_tpu.engine import sql_expr as jax_sql_expr
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu.udf import registry as jax_udf
from sparkdl_tpu_torch.core import executor
from sparkdl_tpu_torch.engine import dataframe as torch_dataframe
from sparkdl_tpu_torch.engine import sql_expr
from sparkdl_tpu_torch.engine.dataframe import EngineConfig
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.image_transformer import TorchImageTransformer
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.udf import registry as torch_udf
from tests.torch_port_helpers import headless, max_abs, random_variables

F32_REL = 1e-3


def _clear():
    for df_mod, udf_mod in ((jax_dataframe, jax_udf),
                            (torch_dataframe, torch_udf)):
        df_mod._temp_views.clear()
        for name in udf_mod.udf_registry.names():
            udf_mod.udf_registry.unregister(name)


@pytest.fixture(autouse=True)
def clean_state():
    saved = EngineConfig.snapshot()
    EngineConfig.device = "cpu"
    EngineConfig.inference_precision = "float32"
    EngineConfig.max_workers = 3
    _clear()
    yield
    _clear()
    executor.reset()
    EngineConfig.restore(saved)


ROWS = [
    {"id": 0, "a": 1, "b": 0.5, "s": "x", "label": 0},
    {"id": 1, "a": 2, "b": None, "s": "y", "label": 1},
    {"id": 2, "a": 3, "b": 2.5, "s": None, "label": 1},
    {"id": 3, "a": 4, "b": -1.0, "s": "x", "label": 0},
    {"id": 4, "a": 5, "b": None, "s": "z", "label": 1},
    {"id": 5, "a": 6, "b": 7.0, "s": "x", "label": 0},
    {"id": 6, "a": 7, "b": 0.0, "s": "y", "label": 1},
]


def _frames(rows=ROWS, parts=3):
    names = list(rows[0])
    ref = sparkdl_tpu.DataFrame.fromRows(rows, numPartitions=parts)
    ours = sparkdl_tpu_torch.DataFrame.fromColumns(
        {n: [r[n] for r in rows] for n in names}, numPartitions=parts)
    return ref, ours


EXPRESSIONS = ["a", "a as x", "*", "1", "'lit' AS l", "f(a)", "g(f(a), b)",
               "f(2.5) as two"]
CONDITIONS = ["a > 2", "a = 2", "a == 2", "a != 2", "a <> 2", "b < 1",
              "b <= 0.5", "b >= 0", "b IS NULL", "b IS NOT NULL",
              "s = 'x'", "s IS NULL", "NOT (a = 1) OR s = 'x'",
              "b > 0.5 AND (a < 4 OR s = 'x')", "NOT b > 0", "1 = 1",
              "1 = 2", "a = label", "'x' = s"]


@pytest.mark.parametrize("text", EXPRESSIONS)
def test_parse_matches_reference(text):
    assert repr(sql_expr.parse(text)) == repr(jax_sql_expr.parse(text))


@pytest.mark.parametrize("text", CONDITIONS)
def test_eval_bool_matches_reference_with_nulls(text):
    ours, ref = sql_expr.parse_bool(text), jax_sql_expr.parse_bool(text)
    assert repr(ours) == repr(ref)
    assert sql_expr.bool_columns(ours) == jax_sql_expr.bool_columns(ref)
    for row in ROWS:
        assert sql_expr.eval_bool(ours, row) == \
            jax_sql_expr.eval_bool(ref, row)


def test_split_query_and_default_name_match_reference():
    for q in ["SELECT a, f(b) AS y FROM t WHERE a > 1",
              "select * from images",
              "SELECT 'x' as c FROM v where s IS NULL"]:
        assert sql_expr.split_query(q) == jax_sql_expr.split_query(q)
    for e in ["f(a)", "g(f(a), b)", "1"]:
        assert sql_expr.default_name(e) == jax_sql_expr.default_name(e)
    with pytest.raises(ValueError):
        sql_expr.parse_bool("a >")
    with pytest.raises(ValueError):
        jax_sql_expr.parse_bool("a >")


def _rows(frame):
    return [{k: (None if v is None else v) for k, v in r.items()}
            for r in frame.collect()]


@pytest.mark.parametrize("cond", CONDITIONS)
def test_where_matches_reference(cond):
    ref, ours = _frames()
    assert _rows(ours.where(cond)) == _rows(ref.where(cond))


def _register_row_udfs():
    for mod in (jax_udf, torch_udf):
        mod.registerUDF("f", lambda v: None if v is None else v * 10)
        mod.registerUDF("g", lambda u, v: None if v is None else u + v,
                        arity=2)


def test_select_expr_matches_reference():
    _register_row_udfs()
    ref, ours = _frames()
    exprs = EXPRESSIONS[1:]  # "a" beside "*" would name two columns a
    assert _rows(ours.selectExpr(*exprs)) == _rows(ref.selectExpr(*exprs))
    assert _rows(ours.selectExpr("a")) == _rows(ref.selectExpr("a"))
    with pytest.raises(KeyError):
        ours.selectExpr("nope")
    with pytest.raises(ValueError, match="takes 2 argument"):
        ours.selectExpr("g(a)")


def test_sql_and_table_match_reference():
    _register_row_udfs()
    ref, ours = _frames()
    ref.createOrReplaceTempView("t")
    ours.createOrReplaceTempView("t")
    assert torch_dataframe.table("t") is ours
    for q in ["SELECT * FROM t", "SELECT a, f(b) AS fb FROM t WHERE b > 0",
              "SELECT g(a, b) AS s, label FROM t WHERE label = 1",
              "SELECT id FROM t WHERE s IS NULL OR a >= 6"]:
        assert _rows(sparkdl_tpu_torch.sql(q)) == _rows(sparkdl_tpu.sql(q))
    with pytest.raises(KeyError, match="No temp view"):
        sparkdl_tpu_torch.table("missing")
    with pytest.raises(ValueError, match="Bad view name"):
        ours.createOrReplaceTempView("a b")


def test_frame_ops_match_reference():
    ref, ours = _frames()
    cases = [
        lambda df: df.filter(lambda a, b: b is not None and a > b,
                             inputCols=["a", "b"]),
        lambda df: df.dropna(),
        lambda df: df.dropna(subset=["s"]),
        lambda df: df.limit(4),
        lambda df: df.where("a > 3").limit(2),
        lambda df: df.withColumnRenamed("a", "alpha"),
        lambda df: df.withConstantColumn("k", 3),
        lambda df: df.select("id", "b").cache().limit(20),
    ]
    for op in cases:
        got, want = op(ours), op(ref)
        assert got.columns == want.columns
        assert _rows(got) == _rows(want)
    with pytest.raises(KeyError):
        ours.withColumnRenamed("nope", "x")


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("weights", [[0.75, 0.25], [1.0, 2.0, 3.0]])
def test_random_split_puts_the_reference_rows_in_each_split(seed, weights):
    rows = [{"id": i, "v": float(i) * 0.5} for i in range(37)]
    ref, ours = _frames(rows, parts=4)
    got = [[r["id"] for r in part.collect()]
           for part in ours.randomSplit(weights, seed=seed)]
    want = [[r["id"] for r in part.collect()]
            for part in ref.randomSplit(weights, seed=seed)]
    assert got == want
    assert sorted(i for part in got for i in part) == list(range(37))
    assert [p.numPartitions for p in ours.randomSplit(weights, seed)] \
        == [p.numPartitions for p in ref.randomSplit(weights, seed)]
    with pytest.raises(ValueError):
        ours.randomSplit([1.0, 0.0])


@pytest.fixture(scope="module")
def testnet():
    variables = random_variables(jax_testnet.TestNet(include_top=True),
                                 (1, 32, 32, 3), seed=141)
    rng = np.random.default_rng(142)
    arrays = [rng.integers(0, 256, size=(36, 40, 3), dtype=np.uint8)
              for _ in range(10)]
    arrays[4] = None  # a null image row
    return headless(variables), arrays


def _image_frames(arrays):
    origins = [f"img{i}" for i in range(len(arrays))]
    labels = [i % 2 for i in range(len(arrays))]
    ref = sparkdl_tpu.DataFrame.fromArrow(pa.table({
        "image": jax_imageIO.imageArraysToStructColumn(arrays, origins),
        "label": pa.array(labels)}), numPartitions=3)
    ours = sparkdl_tpu_torch.DataFrame.fromColumns({
        "image": imageIO.imageArraysToStructColumn(arrays, origins),
        "label": labels}, numPartitions=3)
    return ref, ours


@pytest.mark.parametrize("preprocessor", [None, "flip"])
def test_register_image_udf_matches_direct_transform_and_reference(
        testnet, preprocessor):
    weights, arrays = testnet
    pre = None if preprocessor is None else (lambda a: a[:, ::-1])
    mf = registry.build_featurizer("TestNet", weights=weights)
    jmf = jax_registry.build_featurizer("TestNet", weights=weights)
    sparkdl_tpu_torch.registerImageUDF("featurize", mf, batchSize=4,
                                       preprocessor=pre)
    jax_udf.registerImageUDF("featurize", jmf, batchSize=4,
                             preprocessor=pre)
    ref, ours = _image_frames(arrays)
    ref.createOrReplaceTempView("images")
    ours.createOrReplaceTempView("images")
    query = ("SELECT featurize(image) AS features, label FROM images "
             "WHERE label = 1")
    got = sparkdl_tpu_torch.sql(query).collect()
    want = sparkdl_tpu.sql(query).collect()
    assert [r["label"] for r in got] == [r["label"] for r in want] \
        == [1] * 5
    assert [r["features"] is None for r in got] \
        == [r["features"] is None for r in want]
    present = [i for i, r in enumerate(want) if r["features"] is not None]
    ref_feats = np.array([want[i]["features"] for i in present])
    our_feats = np.array([got[i]["features"] for i in present])
    assert max_abs(our_feats, ref_feats) <= F32_REL * np.abs(ref_feats).max()
    if preprocessor is None:
        direct = TorchImageTransformer(
            inputCol="image", outputCol="features", modelFunction=mf,
            batchSize=4).transform(ours.where("label = 1")).collect()
        assert all((a["features"] is None and b["features"] is None)
                   or np.array_equal(a["features"], b["features"])
                   for a, b in zip(got, direct))


def test_unported_udf_kinds_raise():
    with pytest.raises(NotImplementedError, match="tensor_transformer"):
        sparkdl_tpu_torch.udf.registerTensorUDF("t", None)
    with pytest.raises(NotImplementedError, match="keras_ingest"):
        sparkdl_tpu_torch.udf.registerKerasImageUDF("k", "model.h5")
    with pytest.raises(KeyError, match="No UDF named"):
        torch_udf.udf_registry.get("missing")
    torch_udf.registerUDF("once", abs)
    with pytest.raises(ValueError, match="already registered"):
        torch_udf.udf_registry.register(
            torch_udf.udf_registry.get("once"), replace=False)


def test_views_and_udfs_register_from_many_threads():
    _, ours = _frames()
    errors = []

    def work(i):
        try:
            ours.createOrReplaceTempView(f"v{i}")
            torch_udf.registerUDF(f"u{i}", lambda v, i=i: v + i)
            assert torch_dataframe.table(f"v{i}") is ours
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(torch_udf.udf_registry.names()) == 16
    assert sorted(torch_dataframe._temp_views) == sorted(
        f"v{i}" for i in range(16))
