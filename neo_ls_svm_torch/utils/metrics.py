"""Scoring metrics (sklearn-free re-implementations of the ones the estimator and the
benchmark protocol need; the reference's headline classification metric is ROC-AUC via
``predict_proba``, ref ``benchmark/classification.py:110-112``).

A copy of ``neo_ls_svm_tpu.utils.metrics``: the port imports nothing of the JAX package."""

import numpy as np
import numpy.typing as npt


def accuracy_score(
    y_true: npt.NDArray,
    y_pred: npt.NDArray,
    sample_weight: npt.NDArray | None = None,
) -> float:
    """Weighted classification accuracy."""
    correct = (np.asarray(y_true) == np.asarray(y_pred)).astype(np.float64)
    if sample_weight is None:
        return float(np.mean(correct))
    w = np.asarray(sample_weight, dtype=np.float64)
    return float(np.sum(w * correct) / np.sum(w))


def r2_score(
    y_true: npt.NDArray,
    y_pred: npt.NDArray,
    sample_weight: npt.NDArray | None = None,
) -> float:
    """Weighted coefficient of determination R²."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else np.asarray(sample_weight, np.float64)
    y_mean = np.sum(w * y_true) / np.sum(w)
    ss_res = np.sum(w * (y_true - y_pred) ** 2)
    ss_tot = np.sum(w * (y_true - y_mean) ** 2)
    if ss_tot == 0.0:
        # Constant y_true: R² is ill-defined; sklearn's convention is 1.0 for a
        # perfect fit and 0.0 otherwise (never -inf/nan).
        return 1.0 if ss_res == 0.0 else 0.0
    return float(1.0 - ss_res / ss_tot)
