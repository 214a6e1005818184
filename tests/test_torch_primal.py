"""The port's primal solvers and serving functions match the JAX package's.

The same NumPy operands (made from a seed) go through the JAX function and its PyTorch
counterpart on the CPU in float64. γ must be equal; arrays match at rtol 1e-6,
atol 1e-10. The eigenbasis Qs is never compared elementwise (eigenvector signs are
free): λ, β, the LOO arrays and predictions are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.models import primal as tp
from neo_ls_svm_tpu.models import primal as jp
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures

from .conftest import make_classification_dataset, make_regression_dataset

RTOL, ATOL = 1e-6, 1e-10
COMPARED = (
    "lam",
    "beta_emb",
    "loo_errors_gammas",
    "loo_residuals",
    "loo_yhat",
    "loo_leverage",
    "loo_std",
    "residuals",
)


def _problem(task: str, n: int = 1024, seed: int = 71) -> tuple[bool, tuple[np.ndarray, ...]]:
    if task == "regression":
        X, y = make_regression_dataset(n=n, seed=seed)
    else:
        X, y_raw = make_classification_dataset(n=n, seed=seed)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    s = np.random.RandomState(seed + 1).rand(n) + 0.25
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    return task == "classification", (X, M_map, b_map, y, s, jp.gamma_grid(np.float64))


def _torch(arrays: tuple[np.ndarray, ...]) -> list[torch.Tensor]:
    return [torch.from_numpy(np.array(a, dtype=np.float64)) for a in arrays]


def _assert_results_match(ours: dict, theirs: dict) -> None:
    assert float(ours["gamma"]) == float(theirs["gamma"])
    assert int(ours["optimum_index"]) == int(theirs["optimum_index"])
    for key in COMPARED:
        np.testing.assert_allclose(
            ours[key].numpy(), np.asarray(theirs[key]), rtol=RTOL, atol=ATOL, err_msg=key
        )
    for key in ("loo_score", "loo_error"):
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]), rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_primal_fit_matches_jax(task: str) -> None:
    is_classifier, arrays = _problem(task)
    theirs = jp.primal_fit(*map(jnp.asarray, arrays), is_classifier=is_classifier)
    ours = tp.primal_fit(*_torch(arrays), is_classifier=is_classifier)
    _assert_results_match(ours, theirs)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_primal_fit_streaming_matches_jax(task: str, padded: bool) -> None:
    is_classifier, arrays = _problem(task, n=1000 if padded else 1024)
    num_samples = None
    if padded:
        # Zero-weight rows up to a chunk multiple, the true row count via num_samples.
        X, M_map, b_map, y, s, gammas = arrays
        pad = 1024 - X.shape[0]
        arrays = (
            np.vstack([X, np.zeros((pad, X.shape[1]))]),
            M_map,
            b_map,
            np.concatenate([y, np.zeros(pad)]),
            np.concatenate([s, np.zeros(pad)]),
            gammas,
        )
        num_samples = 1000
    kwargs = {"is_classifier": is_classifier, "row_chunk": 256, "num_samples": num_samples}
    theirs = jp.primal_fit_streaming(*map(jnp.asarray, arrays), **kwargs)
    ours = tp.primal_fit_streaming(*_torch(arrays), **kwargs)
    _assert_results_match(ours, theirs)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_serving_functions_match_jax(task: str) -> None:
    is_classifier, arrays = _problem(task)
    X, M_map, b_map = arrays[:3]
    fit = jp.primal_fit(*map(jnp.asarray, arrays), is_classifier=is_classifier)
    X_test = np.random.RandomState(73).randn(300, X.shape[1])
    beta, Qs, lam = (np.asarray(fit[k]) for k in ("beta_emb", "Qs", "lam"))
    gamma, inv_c0 = float(fit["gamma"]), float(X.shape[0] * (M_map.shape[1] + 1))
    j_args = [jnp.asarray(a) for a in (X_test, M_map, b_map)]
    t_args = _torch((X_test, M_map, b_map))
    cases = {
        "decision_function": (
            jp.primal_decision_function(*j_args, jnp.asarray(beta)),
            tp.primal_decision_function(*t_args, *_torch((beta,))),
        ),
        "decision_var": (
            jp.primal_decision_var(
                *j_args, *map(jnp.asarray, (beta, Qs, lam, gamma, inv_c0))
            ),
            tp.primal_decision_var(*t_args, *_torch((beta, Qs, lam)), gamma, inv_c0),
        ),
        "predict_var": (
            jp.primal_predict_var(*j_args, *map(jnp.asarray, (Qs, lam, gamma, inv_c0))),
            tp.primal_predict_var(*t_args, *_torch((Qs, lam)), gamma, inv_c0),
        ),
    }
    for name, (theirs, ours) in cases.items():
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL, err_msg=name
        )


def test_inv_c0_scale_casts_before_multiplying() -> None:
    # 5M rows × 513 overflows int32; the scale must still be exact in float64.
    n = torch.tensor(5_000_000, dtype=torch.int32)
    assert float(tp._inv_c0_scale(n, 513, torch.float64, "cpu")) == 5_000_000 * 513.0
    assert float(tp._inv_c0_scale(5_000_000, 513, torch.float64, "cpu")) == 5_000_000 * 513.0
