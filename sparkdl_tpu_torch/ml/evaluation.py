"""Evaluators: the metric side of model selection.

A port of ``sparkdl_tpu.ml.evaluation``: Spark ML's
``MulticlassClassificationEvaluator`` / ``RegressionEvaluator`` /
``BinaryClassificationEvaluator`` param surface
(``predictionCol/labelCol/metricName``, ``evaluate(df) -> float``,
``isLargerBetter``), computed with numpy over the port's frame. The
multiclass and regression evaluators stream the frame's partitions
(``streamPartitions``) and keep sufficient statistics only.
"""

from __future__ import annotations

import numpy as np

from sparkdl_tpu_torch.ml.persistence import ParamsOnlyPersistence
from sparkdl_tpu_torch.param.base import Param, Params, keyword_only
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.shared_params import HasLabelCol


class Evaluator(Params):
    """``evaluate(dataset) -> float`` + ``isLargerBetter()``."""

    def evaluate(self, dataset) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class _HasPredictionCol(Params):
    predictionCol = Param(
        "_HasPredictionCol", "predictionCol", "prediction column name",
        typeConverter=SparkDLTypeConverters.toColumnName)

    def setPredictionCol(self, value):
        return self._set(predictionCol=value)

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)


def _pair_values(col, keep_rows):
    return np.asarray([col[i] for i in keep_rows], np.float64)


def _iter_pair_batches(dataset, prediction_col: str, label_col: str):
    """Yield (pred, label) float64 arrays per partition, nulls dropped.

    Streams via ``streamPartitions``: evaluation memory stays bounded by
    one partition. NULL rows drop (Spark convention); genuine NaN VALUES
    survive into the metric.
    """
    from sparkdl_tpu_torch.engine.dataframe import _col_valid

    frame = dataset.select(prediction_col, label_col)
    for batch in frame.streamPartitions():
        if batch.num_rows == 0:
            continue
        pcol = batch.column(prediction_col)
        lcol = batch.column(label_col)
        keep = np.flatnonzero(_col_valid(pcol) & _col_valid(lcol))
        if not len(keep):
            continue
        yield _pair_values(pcol, keep), _pair_values(lcol, keep)


def _no_rows() -> ValueError:
    return ValueError("no non-null (prediction, label) rows to evaluate")


class MulticlassClassificationEvaluator(Evaluator, _HasPredictionCol,
                                        HasLabelCol, ParamsOnlyPersistence):
    """accuracy / f1 / weightedPrecision / weightedRecall over class-index
    prediction+label columns (Spark's default metric is f1)."""

    _METRICS = ("f1", "accuracy", "weightedPrecision", "weightedRecall")

    metricName = Param("MulticlassClassificationEvaluator", "metricName",
                       f"one of {_METRICS}",
                       typeConverter=SparkDLTypeConverters.supportedNameConverter(list(_METRICS)))

    @keyword_only
    def __init__(self, *, predictionCol: str = "prediction",
                 labelCol: str = "label",
                 metricName: str = "f1") -> None:
        super().__init__()
        self._setDefault(predictionCol="prediction", labelCol="label",
                         metricName="f1")
        self._set(**self._input_kwargs)

    def setMetricName(self, value):
        return self._set(metricName=value)

    def getMetricName(self):
        return self.getOrDefault(self.metricName)

    def evaluate(self, dataset) -> float:
        """Streaming accumulation: per-class tp/fp/fn counts build up
        partition by partition; metrics close over the counts at the end
        (identical values to a whole-dataset computation)."""
        from collections import defaultdict

        tp: dict = defaultdict(float)
        fp: dict = defaultdict(float)
        fn: dict = defaultdict(float)
        n = 0
        correct = 0.0
        for pred, lab in _iter_pair_batches(dataset, self.getPredictionCol(),
                                            self.getLabelCol()):
            n += len(pred)
            hit = pred == lab
            correct += float(hit.sum())
            for c in np.unique(np.concatenate([pred, lab])):
                tp[c] += float(((pred == c) & hit).sum())
                fp[c] += float(((pred == c) & ~hit).sum())
                fn[c] += float(((lab == c) & ~hit).sum())
        if n == 0:
            raise _no_rows()
        metric = self.getMetricName()
        if metric == "accuracy":
            return correct / n
        weights, precisions, recalls, f1s = [], [], [], []
        for c in sorted(set(tp) | set(fp) | set(fn)):
            support = tp[c] + fn[c]
            p = tp[c] / (tp[c] + fp[c]) if tp[c] + fp[c] > 0 else 0.0
            r = tp[c] / support if support > 0 else 0.0
            f1 = 2 * p * r / (p + r) if p + r > 0 else 0.0
            weights.append(support)
            precisions.append(p)
            recalls.append(r)
            f1s.append(f1)
        w = np.asarray(weights) / max(1.0, float(sum(weights)))
        table = {"weightedPrecision": precisions, "weightedRecall": recalls,
                 "f1": f1s}
        return float(np.dot(w, table[metric]))


class RegressionEvaluator(Evaluator, _HasPredictionCol, HasLabelCol,
                          ParamsOnlyPersistence):
    """rmse / mse / mae / r2 over numeric prediction+label columns."""

    _METRICS = ("rmse", "mse", "mae", "r2")

    metricName = Param("RegressionEvaluator", "metricName",
                       f"one of {_METRICS}",
                       typeConverter=SparkDLTypeConverters.supportedNameConverter(list(_METRICS)))

    @keyword_only
    def __init__(self, *, predictionCol: str = "prediction",
                 labelCol: str = "label",
                 metricName: str = "rmse") -> None:
        super().__init__()
        self._setDefault(predictionCol="prediction", labelCol="label",
                         metricName="rmse")
        self._set(**self._input_kwargs)

    def setMetricName(self, value):
        return self._set(metricName=value)

    def getMetricName(self):
        return self.getOrDefault(self.metricName)

    def isLargerBetter(self) -> bool:
        return self.getMetricName() == "r2"

    def evaluate(self, dataset) -> float:
        """Streaming accumulation — memory bounded by one partition.

        SStot uses Chan's parallel Welford merge (running mean + M2), not
        Σlab² − n·mean²: the raw-moment form cancels catastrophically for
        labels with large mean (e.g. timestamps), silently zeroing r2.
        """
        n = 0
        ss_err = abs_err = 0.0
        lab_mean = lab_m2 = 0.0  # Welford running mean / sum of squares
        for pred, lab in _iter_pair_batches(dataset, self.getPredictionCol(),
                                            self.getLabelCol()):
            err = pred - lab
            ss_err += float(np.sum(err ** 2))
            abs_err += float(np.sum(np.abs(err)))
            nb = len(lab)
            batch_mean = float(lab.mean())
            batch_m2 = float(np.sum((lab - batch_mean) ** 2))
            delta = batch_mean - lab_mean
            total = n + nb
            lab_m2 += batch_m2 + delta ** 2 * n * nb / total
            lab_mean += delta * nb / total
            n = total
        if n == 0:
            raise _no_rows()
        metric = self.getMetricName()
        if metric == "mse":
            return ss_err / n
        if metric == "rmse":
            return float(np.sqrt(ss_err / n))
        if metric == "mae":
            return abs_err / n
        return 1.0 - ss_err / lab_m2 if lab_m2 > 0 else 0.0


class BinaryClassificationEvaluator(Evaluator, HasLabelCol,
                                    ParamsOnlyPersistence):
    """areaUnderROC / areaUnderPR over a score + binary-label column.

    Parity: Spark ML's ``BinaryClassificationEvaluator`` (Spark's param
    surface: ``rawPredictionCol``/``labelCol``/``metricName``, default
    metric areaUnderROC). The score column may hold either a
    scalar (decision value / P(class 1)) or a probability/raw vector,
    in which case the LAST element — the positive class, Spark's
    convention for 2-vectors — is used.

    Curve semantics (documented contract, asserted by hand-computed
    tests): points are taken at every distinct score threshold with ties
    grouped; areaUnderROC is the trapezoid integral of TPR over FPR from
    (0,0); areaUnderPR prepends Spark's (recall=0, firstPrecision)
    anchor — the first curve point's precision, matching
    ``BinaryClassificationMetrics`` — and integrates precision over
    recall by trapezoid.

    Unlike the multiclass/regression evaluators (streaming sufficient
    statistics), exact AUC needs the full score vector for the global
    sort, so this one holds all (score, label) pairs — two scalars per
    row, not the dataset.
    """

    _METRICS = ("areaUnderROC", "areaUnderPR")

    rawPredictionCol = Param(
        "BinaryClassificationEvaluator", "rawPredictionCol",
        "score column: scalar or probability/raw vector (last element "
        "= positive class)",
        typeConverter=SparkDLTypeConverters.toColumnName)
    metricName = Param("BinaryClassificationEvaluator", "metricName",
                       f"one of {_METRICS}",
                       typeConverter=SparkDLTypeConverters.supportedNameConverter(list(_METRICS)))

    @keyword_only
    def __init__(self, *, rawPredictionCol: str = "rawPrediction",
                 labelCol: str = "label",
                 metricName: str = "areaUnderROC") -> None:
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction", labelCol="label",
                         metricName="areaUnderROC")
        self._set(**self._input_kwargs)

    def setRawPredictionCol(self, value):
        return self._set(rawPredictionCol=value)

    def getRawPredictionCol(self):
        return self.getOrDefault(self.rawPredictionCol)

    def setMetricName(self, value):
        return self._set(metricName=value)

    def getMetricName(self):
        return self.getOrDefault(self.metricName)

    def _collect_scores(self, dataset):
        rows = dataset.select(self.getRawPredictionCol(),
                              self.getLabelCol()).collect()
        scores, labels = [], []
        for r in rows:
            s, lab = r[self.getRawPredictionCol()], r[self.getLabelCol()]
            if s is None or lab is None:
                continue
            if isinstance(s, (list, tuple, np.ndarray)):
                s = s[-1]
            scores.append(float(s))
            labels.append(float(lab))
        if not scores:
            raise ValueError("no non-null (score, label) rows to evaluate")
        lab = np.asarray(labels)
        if not np.isin(lab, (0.0, 1.0)).all():
            raise ValueError(
                f"{self.getLabelCol()!r} must hold binary 0/1 labels")
        sc = np.asarray(scores)
        if not np.isfinite(sc).all():
            # a diverged model's NaN scores would rank arbitrarily and
            # yield a finite-but-meaningless AUC — fail loudly instead
            raise ValueError(
                f"{self.getRawPredictionCol()!r} contains non-finite scores")
        return sc, lab

    def _curve_points(self, score: np.ndarray, label: np.ndarray):
        """Cumulative (tp, fp) at each distinct descending threshold."""
        order = np.argsort(-score, kind="mergesort")
        s, lab = score[order], label[order]
        last_of_group = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
        tp = np.cumsum(lab)[last_of_group]
        fp = np.cumsum(1.0 - lab)[last_of_group]
        return tp, fp

    def evaluate(self, dataset) -> float:
        score, label = self._collect_scores(dataset)
        tp, fp = self._curve_points(score, label)
        pos, neg = tp[-1], fp[-1]
        if pos == 0 or neg == 0:
            raise ValueError(
                "both classes must be present to compute a binary metric")
        if self.getMetricName() == "areaUnderROC":
            tpr = np.r_[0.0, tp / pos]
            fpr = np.r_[0.0, fp / neg]
            return float(_trapezoid(tpr, fpr))
        recall = np.r_[0.0, tp / pos]
        # Spark parity: the PR curve is anchored at
        # (recall=0, precision=first point's precision) — Spark's
        # BinaryClassificationMetrics prepends (0.0, firstPrecision), NOT
        # an optimistic (0, 1.0), which would inflate AUPR whenever the
        # top-scoring threshold group contains a negative.
        prec_curve = tp / (tp + fp)
        precision = np.r_[prec_curve[0], prec_curve]
        return float(_trapezoid(precision, recall))


# numpy renamed trapz -> trapezoid in 2.0; pyproject leaves numpy unpinned
_trapezoid = getattr(np, "trapezoid", None) or np.trapz
