"""Model-comparison harness (the port's own copy of
`ccgp_tpu/eval/compare.py`): per-model root-mean-square prediction error,
95% prediction-interval coverage, and the combined model's average
calibration quantile (ideal ~ 0.5), as the reference's `compare.GP` +
`Comparison.Summary` compute them (`1D Codes and Designs/1D Combined GP
Public.R:854-903`; the NA-filtering definition of `2D Codes and
Designs/2D Combined GP Isotropic Public.R:685-731`). numpy only.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np


class ModelPrediction(NamedTuple):
    mean: np.ndarray
    lower: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None
    quant: Optional[np.ndarray] = None


class ComparisonSummary(NamedTuple):
    rmspe: Dict[str, float]
    coverage: Dict[str, float]
    average_quantile: Optional[float]


def comparison_summary(y_true, predictions: Dict[str, ModelPrediction],
                       drop_na: bool = True) -> ComparisonSummary:
    """predictions: model name -> ModelPrediction (arrays over test points)."""
    y_true = np.asarray(y_true)
    rmspe, coverage = {}, {}
    avg_q = None
    for name, pred in predictions.items():
        mean = np.asarray(pred.mean)
        mask = (np.isfinite(mean) & np.isfinite(y_true) if drop_na
                else np.ones_like(mean, dtype=bool))
        e = y_true[mask] - mean[mask]
        rmspe[name] = float(np.sqrt(np.mean(e * e)))
        if pred.lower is not None and pred.upper is not None:
            lo = np.asarray(pred.lower)[mask]
            hi = np.asarray(pred.upper)[mask]
            yt = y_true[mask]
            coverage[name] = float(np.mean((yt >= lo) & (yt <= hi)))
        if pred.quant is not None:
            avg_q = float(np.mean(np.asarray(pred.quant)[mask]))
    return ComparisonSummary(rmspe=rmspe, coverage=coverage,
                             average_quantile=avg_q)
