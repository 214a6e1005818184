"""``neo_ls_svm_torch.models.isotonic`` against ``neo_ls_svm_tpu.models.isotonic``.

Both are host NumPy in float64 on the same sort, pooling and PAV, so the thresholds and the
transforms are held **bit-equal** (``assert_array_equal``), on the native loop and on the
Python loop alike.
"""

import numpy as np
import pytest

from neo_ls_svm_torch import native
from neo_ls_svm_torch.models.isotonic import IsotonicCalibrator as TorchCalibrator
from neo_ls_svm_torch.models.isotonic import pool_adjacent_violators
from neo_ls_svm_tpu.models.isotonic import IsotonicCalibrator as JaxCalibrator
from neo_ls_svm_tpu.models.isotonic import pool_adjacent_violators as jax_pav


def _scores(seed: int, n: int = 4000, decimals: int | None = None):
    gen = np.random.RandomState(seed)
    x = gen.randn(n)
    if decimals is not None:
        x = np.round(x, decimals)  # duplicate x values, pooled into one support point
    y = (gen.rand(n) < 1 / (1 + np.exp(-2 * x))).astype(np.float64)
    w = gen.rand(n) + 0.1
    w[gen.rand(n) < 0.05] = 0.0  # zero-weight points are dropped
    return x, y, w


_FITS = {
    "weighted": ({"y_min": 0, "y_max": 1}, 0, None, True),
    "duplicate_x": ({"y_min": 0, "y_max": 1}, 1, 1, True),
    "unweighted": ({}, 2, 2, False),
    "decreasing": ({"increasing": False}, 3, 1, True),
    "clipped_range": ({"y_min": 0.2, "y_max": 0.7}, 4, None, True),
    "float32_scores": ({"y_min": 0, "y_max": 1}, 5, None, True),
}


@pytest.mark.parametrize("loops", ["native", "python"])
@pytest.mark.parametrize("case", sorted(_FITS))
def test_thresholds_equal_the_jax_package_bit_for_bit(case: str, loops: str, monkeypatch) -> None:
    params, seed, decimals, weighted = _FITS[case]
    monkeypatch.setattr(native, "_FORCE_PYTHON", loops == "python")
    x, y, w = _scores(seed, decimals=decimals)
    if case == "float32_scores":
        x = x.astype(np.float32)
    weight = w if weighted else None
    ours = TorchCalibrator(**params).fit(x, y, weight)
    theirs = JaxCalibrator(**params).fit(x, y, weight)
    for attr in ("X_thresholds_", "y_thresholds_"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(theirs, attr), err_msg=attr)  # bit-equal
    assert (ours.X_min_, ours.X_max_) == (theirs.X_min_, theirs.X_max_)
    grid = np.linspace(-5, 5, 777)
    np.testing.assert_array_equal(ours.transform(grid), theirs.transform(grid))
    np.testing.assert_array_equal(ours.predict(grid), ours.transform(grid))


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_adjacent_violators_equals_the_jax_package(seed: int) -> None:
    gen = np.random.RandomState(seed)
    y, w = gen.randn(3000), gen.rand(3000) + 0.1
    np.testing.assert_array_equal(pool_adjacent_violators(y, w), jax_pav(y, w))  # bit-equal


@pytest.mark.parametrize("out_of_bounds", ["clip", "nan", "raise"])
def test_transform_out_of_bounds_as_in_the_jax_package(out_of_bounds: str) -> None:
    x, y, w = _scores(7)
    ours = TorchCalibrator(y_min=0, y_max=1, out_of_bounds=out_of_bounds).fit(x, y, w)
    theirs = JaxCalibrator(y_min=0, y_max=1, out_of_bounds=out_of_bounds).fit(x, y, w)
    inside = np.linspace(ours.X_min_, ours.X_max_, 50)
    np.testing.assert_array_equal(ours.transform(inside), theirs.transform(inside))
    outside = np.array([ours.X_min_ - 1.0, 0.0, ours.X_max_ + 1.0])
    if out_of_bounds == "raise":
        for calibrator in (ours, theirs):
            with pytest.raises(ValueError, match="interpolation range"):
                calibrator.transform(outside)
    else:
        np.testing.assert_array_equal(ours.transform(outside), theirs.transform(outside))
        assert np.isnan(ours.transform(outside)[0]) == (out_of_bounds == "nan")


def test_unknown_out_of_bounds_raises() -> None:
    x, y, w = _scores(8)
    with pytest.raises(ValueError, match="out_of_bounds"):
        TorchCalibrator(out_of_bounds="wrap").fit(x, y, w).transform(x)
