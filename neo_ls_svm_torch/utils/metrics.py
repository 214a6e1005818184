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


def roc_auc_score(
    y_true: npt.NDArray,
    y_score: npt.NDArray,
    sample_weight: npt.NDArray | None = None,
) -> float:
    """Weighted binary ROC-AUC.

    ``y_true`` holds exactly two label values (the larger one is the positive class,
    matching the estimator's ``classes_[1]`` convention); ``y_score`` is any monotone
    score for the positive class. Ties in the score contribute 1/2, i.e. the
    probability interpretation AUC = P(s⁺ > s⁻) + P(s⁺ = s⁻)/2 over weighted
    positive/negative pairs.
    """
    y_true = np.ravel(np.asarray(y_true))
    y_score = np.ravel(np.asarray(y_score)).astype(np.float64)
    classes = np.unique(y_true)
    if len(classes) != 2:
        msg = f"roc_auc_score needs exactly 2 classes, got {len(classes)}."
        raise ValueError(msg)
    pos = y_true == classes[1]
    w = np.ones(len(y_true)) if sample_weight is None else np.asarray(sample_weight, np.float64)
    order = np.argsort(y_score, kind="mergesort")
    s, p, wt = y_score[order], pos[order], w[order]
    w_pos, w_neg = wt * p, wt * ~p
    # Within each tie group, positives see all strictly-lower negatives plus half of
    # the group's own negatives.
    cum_neg = np.cumsum(w_neg)
    _, group_start = np.unique(s, return_index=True)
    group_id = np.cumsum(np.isin(np.arange(len(s)), group_start)) - 1
    neg_before_group = np.concatenate([[0.0], cum_neg])[group_start][group_id]
    neg_in_group = np.add.reduceat(w_neg, group_start)[group_id]
    pairs = np.sum(w_pos * (neg_before_group + 0.5 * neg_in_group))
    total_pos, total_neg = np.sum(w_pos), np.sum(w_neg)
    if total_pos == 0 or total_neg == 0:
        msg = "roc_auc_score needs at least one positive and one negative sample."
        raise ValueError(msg)
    return float(pairs / (total_pos * total_neg))


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
