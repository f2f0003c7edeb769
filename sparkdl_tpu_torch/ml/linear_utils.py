"""Shared helpers for the classical linear learners: weighted
standardization statistics and weight validation.

The port's own copy of ``sparkdl_tpu.ml.linear_utils`` (numpy only), used
by ``ml/classification.py`` and, once ported, ``ml/regression.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np


def weighted_feature_std(x: np.ndarray,
                         w: Optional[np.ndarray]) -> np.ndarray:
    """Per-dimension unbiased std for standardization, weighted when
    ``w`` is given (Spark's weighted summarizer: with integer weights
    this equals the duplicated sample's ddof=1 std, keeping
    weight-k == k-duplicated-rows exact under regularization).
    Zero-variance dimensions return 1.0 so scaling is a no-op there.
    """
    if w is None:
        std = x.std(axis=0, ddof=1)
    else:
        wsum = float(w.sum())
        mu = (w[:, None] * x).sum(axis=0) / wsum
        var = ((w[:, None] * (x - mu) ** 2).sum(axis=0)
               / max(wsum - 1.0, 1e-12))
        std = np.sqrt(var)
    return np.where(std > 0, std, 1.0)


def validate_weights(w: np.ndarray, weight_col: str) -> np.ndarray:
    w = np.asarray(w)
    if (w < 0).any():
        raise ValueError(f"{weight_col!r} holds negative weights")
    return w
