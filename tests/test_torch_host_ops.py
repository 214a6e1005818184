"""The port's copies of the host pre-transform equal the JAX package's bit for bit.

The quantizer, the weighted quantile, the affine separator fit and the ORFF draw are
NumPy and ``np.random.RandomState`` in both packages; the same inputs must give the same
bits (``assert_array_equal``).
"""

import numpy as np
import pytest

from neo_ls_svm_torch.ops import affine as t_affine
from neo_ls_svm_torch.ops import orff as t_orff
from neo_ls_svm_torch.ops import quantizer as t_quantizer
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile as t_weighted_quantile
from neo_ls_svm_tpu.ops import affine as j_affine
from neo_ls_svm_tpu.ops import orff as j_orff
from neo_ls_svm_tpu.ops import quantizer as j_quantizer
from neo_ls_svm_tpu.ops.weighted_quantile import weighted_quantile as j_weighted_quantile

from .conftest import make_classification_dataset, make_regression_dataset

_VECTORS = {
    "gaussian": lambda g: g.randn(2048),
    "heavy_tail": lambda g: g.standard_cauchy(2048),
    "few_values": lambda g: g.randint(0, 7, 2048).astype(np.float64),
    "ties": lambda g: np.round(g.randn(2048), 1),
}


@pytest.mark.parametrize("kind", sorted(_VECTORS))
def test_quantizer_matches(kind: str) -> None:
    x = _VECTORS[kind](np.random.RandomState(91))
    for ours, theirs in zip(
        t_quantizer.hist_quantized_ecdf(x), j_quantizer.hist_quantized_ecdf(x)
    ):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        t_quantizer.sample_bins_quantized_ecdf(x), j_quantizer.sample_bins_quantized_ecdf(x)
    )


@pytest.mark.parametrize(
    "case", ["uniform_axis0", "weighted_axis0", "weighted_axis1", "flat", "vector_q"]
)
def test_weighted_quantile_matches(case: str) -> None:
    gen = np.random.RandomState(92)
    a = gen.randn(300, 6)
    w = gen.rand(300, 6) if case != "uniform_axis0" else np.full((300, 1), 0.5)
    kwargs = {
        "uniform_axis0": {"q": 0.5, "axis": 0},
        "weighted_axis0": {"q": 0.3, "axis": 0},
        "weighted_axis1": {"q": 0.7, "axis": 1},
        "flat": {"q": 0.5, "axis": None},
        "vector_q": {"q": np.array([0.1, 0.5, 0.9]), "axis": 0},
    }[case]
    np.testing.assert_array_equal(
        t_weighted_quantile(a, w, **kwargs), j_weighted_quantile(a, w, **kwargs)
    )


def _task_data(task: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    if task == "regression":
        X, y = make_regression_dataset(n=1500, seed=93)
    else:
        X, y_raw = make_classification_dataset(n=1500, seed=93)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    return X, y, np.random.RandomState(94).rand(len(y)) + 0.25


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_affine_separator_fit_matches(task: str) -> None:
    X, y, s = _task_data(task)
    ours = t_affine.AffineSeparator().fit(X, y, s)
    theirs = j_affine.AffineSeparator().fit(X, y, s)
    for attr in ("shift_", "scale_", "A_"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(theirs, attr), err_msg=attr)
    np.testing.assert_array_equal(ours.transform(X[:50]), theirs.transform(X[:50]))


@pytest.mark.parametrize("cls", ["OrthogonalRandomFourierFeatures", "RandomFourierFeatures"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_orff_draw_and_linear_map_match(task: str, cls: str) -> None:
    X, y, s = _task_data(task)
    ours = getattr(t_orff, cls)(num_features=64).fit(X, y, s)
    theirs = getattr(j_orff, cls)(num_features=64).fit(X, y, s)
    np.testing.assert_array_equal(ours.Z_, theirs.Z_)
    for a, b in zip(ours.linear_map(), theirs.linear_map()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.complexity_matrix, theirs.complexity_matrix)
    np.testing.assert_array_equal(ours.transform(X[:50]), theirs.transform(X[:50]))
