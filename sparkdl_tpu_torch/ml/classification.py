"""Downstream classical learners: LogisticRegression (+ model).

A port of ``sparkdl_tpu.ml.classification``, the consumer of the
reference's flagship workflow ``Pipeline([DeepImageFeaturizer,
LogisticRegression])``, with Spark ML's param surface and the reference's
parity envelope (see :class:`LogisticRegression`). The fit is multinomial
softmax cross-entropy with an L2 penalty, solved by the port's own
L-BFGS (``ml/lbfgs.py``, optax's ``lbfgs()`` at its defaults) over the
full feature matrix on ``EngineConfig.device``: the card unless the
caller sets ``"cpu"``; without a card it raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.ml import lbfgs
from sparkdl_tpu_torch.ml.base import Estimator, Model
from sparkdl_tpu_torch.ml.persistence import ParamsOnlyPersistence
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.converters import (
    SparkDLTypeConverters, TypeConverters,
)
from sparkdl_tpu_torch.param.shared_params import HasLabelCol


class _HasClassifierCols(HasLabelCol):
    featuresCol = Param("_HasClassifierCols", "featuresCol",
                        "input column of fixed-length float vectors",
                        typeConverter=SparkDLTypeConverters.toColumnName)
    predictionCol = Param("_HasClassifierCols", "predictionCol",
                          "output column: predicted class index (float, "
                          "Spark ML convention)",
                          typeConverter=SparkDLTypeConverters.toColumnName)
    probabilityCol = Param("_HasClassifierCols", "probabilityCol",
                           "output column: class probability vector",
                           typeConverter=SparkDLTypeConverters.toColumnName)

    def setFeaturesCol(self, value): return self._set(featuresCol=value)

    def getFeaturesCol(self): return self.getOrDefault(self.featuresCol)

    def setPredictionCol(self, value): return self._set(predictionCol=value)

    def getPredictionCol(self): return self.getOrDefault(self.predictionCol)

    def setProbabilityCol(self, value): return self._set(probabilityCol=value)

    def getProbabilityCol(self): return self.getOrDefault(self.probabilityCol)


def _feature_rows(col):
    """``(x, kept)`` of a partition's feature column: a uniform 2-D numeric
    column is taken as one block (every row kept); otherwise the non-null
    rows are stacked (``kept`` their row numbers) or ``x`` is None."""
    if isinstance(col, np.ndarray) and col.ndim == 2 and col.dtype != object:
        return np.asarray(col, np.float32), np.arange(len(col))
    kept = [i for i, v in enumerate(col) if v is not None]
    if not kept:
        return None, kept
    return np.stack([np.asarray(col[i], np.float32) for i in kept]), kept


def _rows_of(col, kept) -> np.ndarray:
    """The values of ``col`` at rows ``kept`` as one array (a list
    column's values through ``np.asarray``, so a None or a string gives
    an object or string dtype, as in the reference)."""
    if isinstance(col, np.ndarray):
        return col[np.asarray(kept, dtype=np.int64)]
    return np.asarray([col[i] for i in kept])


class LogisticRegression(Estimator, _HasClassifierCols,
                         ParamsOnlyPersistence):
    """Multinomial (softmax) logistic regression on a vector column.

    **Spark ML parity envelope** (the reference's, unchanged):

    ================== =====================================================
    matches Spark      ``featuresCol/labelCol/predictionCol/probabilityCol``,
                       ``maxIter``, ``regParam`` (L2), ``tol``,
                       ``fitIntercept``, ``standardization`` (features are
                       scaled by their unbiased std before the solve and
                       coefficients unscaled after; the intercept is never
                       penalized), ``weightCol`` (loss = Σwᵢ·ceᵢ / Σw +
                       penalty) and ``thresholds`` (predict
                       ``argmax(pᵢ/tᵢ)``, Spark's rule).
    differs            multinomial softmax is the ONLY family (Spark's
                       binary path uses pivoted logistic; probabilities
                       agree, coefficients differ by the usual centering);
                       coefficients are NOT centered post-fit.
    absent             ``elasticNetParam``, ``lowerBoundsOnCoefficients``
                       et al.
    ================== =====================================================

    ``numIterations`` counts L-BFGS iterations as the reference's loop
    does. Each fit also leaves its timings and counts on
    ``model.fitStats``: ``collect_s``, ``fit_s`` (the solve), ``device``,
    ``linesearch_steps``, ``evaluations`` and ``syncs`` (the host's reads
    of the loop's flags).
    """

    maxIter = Param("LogisticRegression", "maxIter",
                    "maximum L-BFGS iterations",
                    typeConverter=TypeConverters.toInt)
    regParam = Param("LogisticRegression", "regParam",
                     "L2 regularization strength (0 disables)",
                     typeConverter=TypeConverters.toFloat)
    tol = Param("LogisticRegression", "tol",
                "convergence tolerance on the gradient norm",
                typeConverter=TypeConverters.toFloat)
    fitIntercept = Param("LogisticRegression", "fitIntercept",
                         "whether to fit an intercept term",
                         typeConverter=TypeConverters.toBoolean)
    standardization = Param(
        "LogisticRegression", "standardization",
        "scale features to unit std before fitting (Spark's default True; "
        "changes the regularized optimum, reported coefficients are always "
        "on the original scale)",
        typeConverter=TypeConverters.toBoolean)
    weightCol = Param(
        "LogisticRegression", "weightCol",
        "optional column of non-negative row weights; the loss becomes "
        "the weighted mean cross-entropy (Spark semantics: weight 2 == "
        "duplicating the row)",
        typeConverter=SparkDLTypeConverters.toColumnName)
    thresholds = Param(
        "LogisticRegression", "thresholds",
        "per-class thresholds; prediction = argmax_i(p_i / t_i) (Spark's "
        "rule); length must equal the class count, values > 0",
        typeConverter=TypeConverters.identity)

    @keyword_only
    def __init__(self, *, featuresCol: str = "features",
                 labelCol: str = "label",
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 maxIter: int = 100, regParam: float = 0.0,
                 tol: float = 1e-6, fitIntercept: bool = True,
                 standardization: bool = True,
                 weightCol: Optional[str] = None,
                 thresholds: Optional[list] = None) -> None:
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability", maxIter=100,
                         regParam=0.0, tol=1e-6, fitIntercept=True,
                         standardization=True)
        self.setParams(**self._input_kwargs)

    @keyword_only
    def setParams(self, *, featuresCol: str = "features",
                  labelCol: str = "label",
                  predictionCol: str = "prediction",
                  probabilityCol: str = "probability",
                  maxIter: int = 100, regParam: float = 0.0,
                  tol: float = 1e-6,
                  fitIntercept: bool = True,
                  standardization: bool = True,
                  weightCol: Optional[str] = None,
                  thresholds: Optional[list] = None) -> "LogisticRegression":
        self._set(**self._input_kwargs)
        return self

    def setMaxIter(self, value): return self._set(maxIter=value)

    def getMaxIter(self): return self.getOrDefault(self.maxIter)

    def setRegParam(self, value): return self._set(regParam=value)

    def getRegParam(self): return self.getOrDefault(self.regParam)

    def setTol(self, value): return self._set(tol=value)

    def getTol(self): return self.getOrDefault(self.tol)

    def setFitIntercept(self, value): return self._set(fitIntercept=value)

    def getFitIntercept(self): return self.getOrDefault(self.fitIntercept)

    def setStandardization(self, value):
        return self._set(standardization=value)

    def getStandardization(self):
        return self.getOrDefault(self.standardization)

    def setWeightCol(self, value):
        return self._set(weightCol=value)

    def getWeightCol(self):
        return (self.getOrDefault(self.weightCol)
                if self.isDefined(self.weightCol) else None)

    def setThresholds(self, value):
        return self._set(thresholds=value)

    def getThresholds(self):
        return (self.getOrDefault(self.thresholds)
                if self.isDefined(self.thresholds) else None)

    def _collect_xy(self, dataset):
        """Features, labels, class count and row weights of the rows with
        a non-null feature vector, one partition at a time (a uniform 2-D
        feature column as one block)."""
        feat_col, label_col = self.getFeaturesCol(), self.getLabelCol()
        weight_col = self.getWeightCol()
        cols = [feat_col, label_col]
        if weight_col is not None:
            cols.append(weight_col)
        blocks, labels, weights = [], [], []
        for batch in dataset.select(*cols).partitionsIter():
            x, kept = _feature_rows(batch.column(feat_col))
            if x is None:
                continue
            blocks.append(x)
            labels.append(_rows_of(batch.column(label_col), kept))
            if weight_col is not None:
                w = batch.column(weight_col)
                weights.extend(1.0 if w[i] is None else float(w[i])
                               for i in kept)
        if not blocks:
            raise ValueError("no non-null feature rows to fit on")
        x = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        y = np.concatenate(labels)
        if y.dtype.kind not in "iuf":
            raise ValueError(
                f"labelCol {label_col!r} must hold numeric class "
                f"indices, got dtype {y.dtype}")
        y = y.astype(np.int32)
        if y.min() < 0:
            raise ValueError("labels must be non-negative class indices")
        w = None
        if weight_col is not None:
            from sparkdl_tpu_torch.ml.linear_utils import validate_weights

            w = validate_weights(np.asarray(weights, np.float32),
                                 weight_col)
        return x, y, int(y.max()) + 1, w

    def _fit(self, dataset) -> "LogisticRegressionModel":
        from sparkdl_tpu_torch.core.executor import resolve_device

        # decided first: without the configured device the fit fails
        # before collecting anything
        device = resolve_device()
        t0 = time.perf_counter()
        x, y, n_classes, sample_w = self._collect_xy(dataset)
        collect_s = time.perf_counter() - t0
        if n_classes < 2:
            n_classes = 2
        thresholds = self.getThresholds()
        if thresholds is not None:
            t = np.asarray(thresholds, np.float64)
            if len(t) != n_classes or (t <= 0).any():
                raise ValueError(
                    f"thresholds must hold {n_classes} positive values, "
                    f"got {thresholds}")
        # Spark semantics: fit in unit-std feature space (intercept
        # unpenalized and unaffected: scaling is shift-free), report
        # coefficients on the original scale
        std = None
        if self.getStandardization() and len(x) > 1:
            from sparkdl_tpu_torch.ml.linear_utils import (
                weighted_feature_std,
            )

            std = weighted_feature_std(x, sample_w).astype(np.float32)
        t0 = time.perf_counter()
        w, b, result = fit_softmax(
            x, y, n_classes, max_iter=self.getMaxIter(),
            reg=self.getRegParam(), tol=self.getTol(),
            fit_intercept=self.getFitIntercept(), sample_weight=sample_w,
            feature_scale=std, device=device)
        fit_s = time.perf_counter() - t0
        if std is not None:
            w = w / std[:, None]
        model = LogisticRegressionModel(
            featuresCol=self.getFeaturesCol(), labelCol=self.getLabelCol(),
            predictionCol=self.getPredictionCol(),
            probabilityCol=self.getProbabilityCol(),
            thresholds=thresholds)
        model._set_weights(w, b)
        model.numIterations = result.iterations
        model.fitStats = {
            "device": str(device), "rows": len(x), "features": x.shape[1],
            "classes": n_classes, "collect_s": collect_s, "fit_s": fit_s,
            "iterations": result.iterations,
            "linesearch_steps": result.linesearch_steps,
            "evaluations": result.evaluations, "syncs": result.syncs}
        model._set_parent(self)
        return model


class SoftmaxObjective:
    """Mean (or weighted mean) softmax cross-entropy + (reg/2)·||W||² over
    the flat parameter vector ``[W (d×k, row-major), b (k)]``, with its
    gradient in closed form, on the device of ``x``. The intercept is
    never penalized; without ``fit_intercept`` it is held at 0 (its
    gradient is 0), as in the reference, which optimizes it all the
    same."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, n_classes: int,
                 reg: float, fit_intercept: bool,
                 sample_weight: Optional[torch.Tensor] = None) -> None:
        self.x = x
        self.d = x.shape[1]
        self.k = n_classes
        self.reg = reg
        self.fit_intercept = fit_intercept
        self.labels = y.long()[:, None]
        self.onehot = torch.nn.functional.one_hot(
            y.long(), n_classes).to(x.dtype)
        self.n = x.shape[0]
        self.sample_weight = sample_weight
        if sample_weight is not None:
            self.weight_sum = sample_weight.sum()

    def split(self, params: torch.Tensor):
        dk = self.d * self.k
        return params[:dk].view(self.d, self.k), params[dk:]

    def __call__(self, params: torch.Tensor):
        w, b = self.split(params)
        logits = self.x @ w
        if self.fit_intercept:
            logits = logits + b
        # optax.softmax_cross_entropy_with_integer_labels: the max-shifted
        # log-normalizer less the label's logit
        shifted = logits - logits.max(dim=1, keepdim=True).values
        log_norm = torch.log(torch.exp(shifted).sum(dim=1))
        ce_rows = log_norm - shifted.gather(1, self.labels)[:, 0]
        residual = torch.softmax(shifted, dim=1) - self.onehot
        if self.sample_weight is None:
            ce = ce_rows.mean()
            g_logits = residual / self.n
        else:
            ce = (ce_rows * self.sample_weight).sum() / self.weight_sum
            g_logits = (residual * self.sample_weight[:, None]
                        / self.weight_sum)
        value = ce + 0.5 * self.reg * (w * w).sum()
        g_w = self.x.T @ g_logits + self.reg * w
        g_b = (g_logits.sum(dim=0) if self.fit_intercept
               else torch.zeros_like(b))
        return value, torch.cat([g_w.reshape(-1), g_b])


def fit_softmax(x: np.ndarray, y: np.ndarray, n_classes: int,
                max_iter: int, reg: float, tol: float, fit_intercept: bool,
                sample_weight: Optional[np.ndarray] = None,
                feature_scale: Optional[np.ndarray] = None,
                device="cpu"):
    """L-BFGS from zero on the (weighted) mean softmax-CE + (reg/2)·||W||²
    over ``x / feature_scale`` on ``device``, float32 throughout. Returns
    the coefficients and intercept on the host and the solver's
    :class:`~sparkdl_tpu_torch.ml.lbfgs.LBFGSResult`."""
    device = torch.device(device)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    if feature_scale is not None:
        xd = xd / torch.from_numpy(feature_scale).to(device)
    yd = torch.from_numpy(np.asarray(y)).to(device)
    wd = (None if sample_weight is None
          else torch.from_numpy(np.asarray(sample_weight, np.float32))
          .to(device))
    objective = SoftmaxObjective(xd, yd, n_classes, reg, fit_intercept, wd)
    params0 = torch.zeros(x.shape[1] * n_classes + n_classes,
                          dtype=torch.float32, device=device)
    result = lbfgs.minimize(objective, params0, max_iter=max_iter, tol=tol)
    w, b = objective.split(result.x)
    return (w.cpu().numpy(), b.cpu().numpy(), result)


class LogisticRegressionModel(Model, _HasClassifierCols):
    """Fitted model: adds prediction (+ probability) columns.

    With ``thresholds`` set, prediction is ``argmax_i(p_i / t_i)``
    (Spark's multiclass thresholding rule); otherwise plain argmax. The
    scoring runs in numpy on the partition threads, as the reference's.
    """

    thresholds = Param("LogisticRegressionModel", "thresholds",
                       "per-class thresholds applied at prediction time",
                       typeConverter=TypeConverters.identity)

    @keyword_only
    def __init__(self, *, featuresCol: str = "features",
                 labelCol: str = "label",
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 thresholds: Optional[list] = None) -> None:
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability")
        self._set(**self._input_kwargs)
        self.numIterations: Optional[int] = None
        self.fitStats: Dict[str, object] = {}

    def getThresholds(self):
        return (self.getOrDefault(self.thresholds)
                if self.isDefined(self.thresholds) else None)

    def _set_weights(self, w: np.ndarray, b: np.ndarray) -> None:
        self._w = np.asarray(w, np.float32)
        self._b = np.asarray(b, np.float32)

    @property
    def coefficients(self) -> np.ndarray:
        return self._w

    @property
    def intercept(self) -> np.ndarray:
        return self._b

    @property
    def numClasses(self) -> int:
        return int(self._w.shape[1])

    def _transform(self, dataset):
        w, b = self._w, self._b
        feat_col = self.getFeaturesCol()

        def predict_batch(batch):
            x, kept = _feature_rows(batch.column(feat_col))
            if x is None:
                return [None] * batch.num_rows
            logits = x @ w + b
            logits -= logits.max(axis=1, keepdims=True)
            e = np.exp(logits)
            probs = e / e.sum(axis=1, keepdims=True)
            if len(kept) == batch.num_rows:
                return probs
            out: list = [None] * batch.num_rows
            for j, i in enumerate(kept):
                out[i] = probs[j]
            return out

        thresholds = self.getThresholds()
        t = (np.asarray(thresholds, np.float64)
             if thresholds is not None else None)

        def decide(p):
            if p is None:
                return None
            probs = np.asarray(p, np.float64)
            if t is not None:
                probs = probs / t  # Spark's rule: argmax(p_i / t_i)
            return float(int(np.argmax(probs)))

        with_probs = dataset.withColumnBatch(self.getProbabilityCol(),
                                             predict_batch)
        return with_probs.withColumn(
            self.getPredictionCol(), decide,
            inputCols=[self.getProbabilityCol()])

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        import os

        from sparkdl_tpu_torch.ml import persistence as P

        os.makedirs(path, exist_ok=True)
        params = P.jsonable_params(self)
        np.savez(os.path.join(path, "weights.npz"), w=self._w, b=self._b)
        P.write_metadata(path, self, params, {"weights": "weights.npz"})

    @classmethod
    def _load_from(cls, path: str, meta):
        import os

        inst = cls(**meta["params"])
        data = np.load(os.path.join(path, meta["artifacts"]["weights"]))
        inst._set_weights(data["w"], data["b"])
        return inst
