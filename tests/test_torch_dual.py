"""The port's dual route (``ops/kernels.py``, ``models/dual.py``) against the JAX package's,
on the CPU in float64, on the same NumPy inputs made from a seed.

``squared_distances`` and ``rbf_kernel`` at rtol 1e-12, with the ``same=True`` diagonal
exactly 0. ``dual_fit`` on the same transformed X for a regressor and a classifier, with and
without sample weights, at an odd and an even n (the median of the weights averages the two
middle values of an even-length vector): γ equal, α̂, the LOO arrays and ``loo_score`` at
rtol 1e-6. The serving functions at rtol 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.models import dual as t_dual
from neo_ls_svm_torch.models.primal import gamma_grid
from neo_ls_svm_torch.ops import kernels as t_kernels
from neo_ls_svm_torch.ops.affine import AffineSeparator
from neo_ls_svm_tpu.models import dual as j_dual
from neo_ls_svm_tpu.ops import kernels as j_kernels

from .conftest import make_classification_dataset, make_regression_dataset

# The suite runs several worker processes on a few cores: more intra-op threads than that
# only contend (these shapes are small).
torch.set_num_threads(2)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("same", [False, True])
def test_kernels_match_jax(same: bool) -> None:
    gen = np.random.RandomState(0)
    X = gen.randn(200, 7)
    Y = X if same else gen.randn(150, 7)
    for ours_fn, theirs_fn, kw in (
        (t_kernels.squared_distances, j_kernels.squared_distances, {}),
        (t_kernels.rbf_kernel, j_kernels.rbf_kernel, {"gamma": 0.5}),
    ):
        ours = ours_fn(_t(X), _t(Y), same=same, **kw).numpy()
        theirs = np.asarray(theirs_fn(jnp.asarray(X), jnp.asarray(Y), same=same, **kw))
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-14)
        assert np.all(ours >= 0)
    if same:
        np.testing.assert_array_equal(np.diag(t_kernels.squared_distances(_t(X), _t(X), same=True).numpy()), 0.0)
        np.testing.assert_array_equal(np.diag(t_kernels.rbf_kernel(_t(X), _t(X), same=True).numpy()), 1.0)


def test_squared_distances_clamps_at_zero() -> None:
    """Two copies of one far-off row: the expansion's rounding may go below 0 and is clamped
    (sklearn's convention)."""
    X = np.full((3, 4), 1e8) + np.arange(3)[:, None] * 1e-8
    assert np.all(t_kernels.squared_distances(_t(X), _t(X)).numpy() >= 0)


def _dual_inputs(task: str, weighted: bool, n: int) -> dict[str, np.ndarray]:
    if task == "regression":
        X, y = make_regression_dataset(n=n + 100, seed=7)
    else:
        X, labels = make_classification_dataset(n=n + 100, seed=7)
        y = np.where(labels == "pos", 1.0, -1.0)
    w = np.random.RandomState(n).rand(n + 100) + 0.25 if weighted else np.ones(n + 100)
    fmap = AffineSeparator().fit(X[:n], y[:n], w[:n])
    return {
        "X": fmap.transform(X[:n]),
        "y": y[:n],
        "w": w[:n],
        "X_test": fmap.transform(X[n:]),
        "gammas": gamma_grid(np.float64, num=128),
    }


def _fit_both(task: str, weighted: bool, n: int) -> tuple[dict, dict, dict]:
    data = _dual_inputs(task, weighted, n)
    is_classifier = task == "classification"
    ours = t_dual.dual_fit(
        _t(data["X"]), _t(data["y"]), _t(data["w"]), _t(data["gammas"]), is_classifier=is_classifier
    )
    theirs = j_dual.dual_fit(
        *(jnp.asarray(data[k]) for k in ("X", "y", "w", "gammas")), is_classifier=is_classifier
    )
    return {k: v.numpy() for k, v in ours.items()}, {k: np.asarray(v) for k, v in theirs.items()}, data


@pytest.mark.parametrize("n", [300, 301])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_dual_fit_matches_jax(task: str, weighted: bool, n: int) -> None:
    ours, theirs, _ = _fit_both(task, weighted, n)
    assert sorted(ours) == sorted(theirs)
    assert ours["gamma"] == theirs["gamma"]
    assert ours["optimum_index"] == theirs["optimum_index"]
    for k in ("alpha", "loo_residuals", "loo_yhat", "loo_std", "loo_score", "loo_error", "loo_errors_gammas", "residuals", "chol"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=1e-10, err_msg=k)


def test_dual_fit_with_a_complexity_term_matches_jax() -> None:
    """ρ ≠ 1 brings in the surface-complexity regulariser (inert at the default ρ = 1)."""
    data = _dual_inputs("regression", True, 200)
    args = ("X", "y", "w", "gammas")
    ours = t_dual.dual_fit(*(_t(data[k]) for k in args), rho=0.8, is_classifier=False)
    theirs = j_dual.dual_fit(*(jnp.asarray(data[k]) for k in args), rho=0.8, is_classifier=False)
    assert float(ours["gamma"]) == float(theirs["gamma"])
    np.testing.assert_allclose(ours["alpha"].numpy(), np.asarray(theirs["alpha"]), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_dual_serving_matches_jax(task: str) -> None:
    ours, theirs, data = _fit_both(task, True, 301)
    X_test, X_train = data["X_test"], data["X"]
    # The same fitted state on both sides (the JAX fit's), so that only serving is compared.
    alpha, chol = theirs["alpha"], theirs["chol"]
    yhat_j = np.asarray(j_dual.dual_decision_function(jnp.asarray(X_test), jnp.asarray(X_train), jnp.asarray(alpha)))
    var_j = np.asarray(j_dual.dual_predict_var(jnp.asarray(X_test), jnp.asarray(X_train), jnp.asarray(chol)))
    both_j = np.asarray(
        j_dual.dual_decision_var(jnp.asarray(X_test), jnp.asarray(X_train), jnp.asarray(alpha), jnp.asarray(chol))
    )
    yhat_t = t_dual.dual_decision_function(_t(X_test), _t(X_train), _t(alpha)).numpy()
    var_t = t_dual.dual_predict_var(_t(X_test), _t(X_train), _t(chol)).numpy()
    both_t = t_dual.dual_decision_var(_t(X_test), _t(X_train), _t(alpha), _t(chol)).numpy()
    np.testing.assert_allclose(yhat_t, yhat_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(var_t, var_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(both_t, both_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(both_t[:, 0], yhat_t)
    np.testing.assert_array_equal(both_t[:, 1], var_t)
