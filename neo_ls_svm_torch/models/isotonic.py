"""Isotonic regression via pool-adjacent-violators, for probability calibration.

Replaces the reference's use of ``sklearn.isotonic.IsotonicRegression(out_of_bounds=
"clip", y_min=0, y_max=1, increasing=True)`` (ref ``_neo_ls_svm.py:407-412``). PAV is an
inherently sequential O(n) stack algorithm over sorted data: a host-side scan, like the
reference's choice. Calibration happens once per fitted classifier, on the leave-one-out
predictions of every training row. Transforms interpolate linearly between learned
thresholds and clip out-of-range inputs.

A copy of ``neo_ls_svm_tpu.models.isotonic`` (host NumPy, float64, bit-equal to it) on the
port's own native library.
"""

import numpy as np
import numpy.typing as npt

from neo_ls_svm_torch import native
from neo_ls_svm_torch.utils.base import BaseEstimator, RegressorMixin
from neo_ls_svm_torch.utils.validation import check_is_fitted


def pool_adjacent_violators(
    y: npt.NDArray[np.floating], w: npt.NDArray[np.floating]
) -> npt.NDArray[np.floating]:
    """Weighted isotonic (non-decreasing) fit minimising Σ wᵢ(yᵢ - ŷᵢ)²; O(n) stack PAV.

    Runs the native C++ loop (``native/pav.cpp``) where the library could be built: the
    classifier calibrator fits on every training row's LOO prediction, so n reaches
    millions. The Python loop below is the plain version that defines the semantics;
    both give identical bits (:func:`_pav_python` is held against the native loop).
    """
    y, w = np.asarray(y, dtype=np.float64), np.asarray(w, dtype=np.float64)
    if native.available():
        return native.pav_fit(y, w)
    return _pav_python(y, w)


def _pav_python(y: npt.NDArray[np.floating], w: npt.NDArray[np.floating]) -> npt.NDArray[np.floating]:
    """The O(n) stack loop in Python."""
    n = len(y)
    # Each stack block: [mean, weight, count].
    means = np.empty(n)
    weights = np.empty(n)
    counts = np.empty(n, dtype=np.intp)
    top = 0
    for i in range(n):
        means[top], weights[top], counts[top] = y[i], w[i], 1
        top += 1
        while top > 1 and means[top - 2] >= means[top - 1]:
            wa, wb = weights[top - 2], weights[top - 1]
            merged = (means[top - 2] * wa + means[top - 1] * wb) / (wa + wb)
            means[top - 2] = merged
            weights[top - 2] = wa + wb
            counts[top - 2] += counts[top - 1]
            top -= 1
    return np.repeat(means[:top], counts[:top])


class IsotonicCalibrator(RegressorMixin, BaseEstimator):
    """Isotonic calibrator with sklearn-compatible clipping semantics."""

    def __init__(
        self,
        *,
        y_min: float | None = None,
        y_max: float | None = None,
        increasing: bool = True,
        out_of_bounds: str = "clip",
    ) -> None:
        self.y_min = y_min
        self.y_max = y_max
        self.increasing = increasing
        self.out_of_bounds = out_of_bounds

    def fit(
        self,
        X: npt.NDArray[np.floating],
        y: npt.NDArray[np.floating],
        sample_weight: npt.NDArray[np.floating] | None = None,
    ) -> "IsotonicCalibrator":
        """Fit the monotone step/interpolation function on (X, y)."""
        x = np.ravel(np.asarray(X, dtype=np.float64))
        y = np.ravel(np.asarray(y, dtype=np.float64))
        w = np.ones_like(y) if sample_weight is None else np.ravel(np.asarray(sample_weight))
        w = w.astype(np.float64)
        keep = w > 0
        x, y, w = x[keep], y[keep], w[keep]
        # Secondary sort on y stabilises duplicate-x groups (sklearn's lexsort order).
        order = np.lexsort((y, x))
        x, y, w = x[order], y[order], w[order]
        if not self.increasing:
            y = -y
        # Weighted-average duplicate x values into single support points.
        uniq, start = np.unique(x, return_index=True)
        sums_w = np.add.reduceat(w, start)
        sums_wy = np.add.reduceat(w * y, start)
        y_mean = sums_wy / sums_w
        y_fit = pool_adjacent_violators(y_mean, sums_w)
        if not self.increasing:
            y_fit = -y_fit
        lo = -np.inf if self.y_min is None else self.y_min
        hi = np.inf if self.y_max is None else self.y_max
        y_fit = np.clip(y_fit, lo, hi)
        self.X_thresholds_ = uniq
        self.y_thresholds_ = y_fit
        self.X_min_, self.X_max_ = uniq[0], uniq[-1]
        return self

    def transform(self, X: npt.NDArray[np.floating]) -> npt.NDArray[np.floating]:
        """Interpolate the calibrated values, honouring ``out_of_bounds`` like
        sklearn's ``IsotonicRegression``: "clip" clamps to the end values, "nan"
        returns NaN outside the training domain, "raise" raises ValueError."""
        check_is_fitted(self, ["X_thresholds_"])
        x = np.ravel(np.asarray(X, dtype=np.float64))
        if self.out_of_bounds not in ("clip", "nan", "raise"):
            msg = (
                f"The argument ``out_of_bounds`` must be in 'nan', 'clip', 'raise'; "
                f"got {self.out_of_bounds!r}"
            )
            raise ValueError(msg)
        outside = (x < self.X_min_) | (x > self.X_max_)
        if self.out_of_bounds == "raise" and np.any(outside):
            msg = "A value in x_new is below the interpolation range's minimum or above its maximum."
            raise ValueError(msg)
        # np.interp clamps to the end values, which is exactly out_of_bounds="clip".
        out = np.interp(x, self.X_thresholds_, self.y_thresholds_)
        if self.out_of_bounds == "nan":
            out = np.where(outside, np.nan, out)
        return out

    predict = transform
