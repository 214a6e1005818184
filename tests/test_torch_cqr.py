"""``neo_ls_svm_torch.models.cqr`` against ``neo_ls_svm_tpu.models.cqr`` (x64 on).

The host code is a copy, and the exact path solves the same LP with the same HiGHS, so
``β_``, ``β_full_`` and ``intercept_clip`` are held at **rtol 1e-9**. The smooth solver runs
the same damped Newton in float64 through ``torch.func``: its objective, gradient and
Hessian are held against ``jax.grad``/``jax.hessian`` at rtol 1e-10, one stage at rtol 1e-8,
and the whole solve's ``β_full_`` at **rtol 1e-5**. The ``argmin`` over the 31 candidate
steps can pick another step on a near-tie than JAX does, after which the two iterates part
in the last digits; where that happens the solutions are still the same optimum, so the
exact pinball loss is held at rtol 1e-8 and the predictions at 1e-6 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.models import cqr as t_cqr
from neo_ls_svm_tpu.models import cqr as j_cqr

torch.set_num_threads(2)


def _problem(seed: int, n: int = 300, intercept_scale: float = 1.0):
    """A conformal-shaped design: a nonnegative score and |ŷ| against signed residuals."""
    gen = np.random.RandomState(seed)
    X = np.abs(gen.randn(n, 2)) * np.array([0.5, 2.0])
    y = X[:, 0] * gen.randn(n) + 0.1 * X[:, 1] + intercept_scale * 0.05
    w = gen.rand(n) + 0.5
    return X, y, w


def _pinball(X, y, w, beta, quantiles) -> float:
    r = y[:, None] - np.hstack([X, np.ones((len(X), 1))]) @ beta
    q = np.asarray(quantiles)
    return float((w / w.sum()) @ np.maximum(q * r, (q - 1) * r).mean(axis=1))


def test_host_helpers_equal_the_jax_package() -> None:
    q = np.array([0.025, 0.5, 0.975])
    np.testing.assert_array_equal(t_cqr._extend_quantiles(q, 3), j_cqr._extend_quantiles(q, 3))
    Xs = np.random.RandomState(0).randn(50, 3)
    Xs[:, 2] = 1.0
    np.testing.assert_array_equal(t_cqr._monotonicity_box(Xs), j_cqr._monotonicity_box(Xs))
    wide = np.random.RandomState(1).randn(30, 12)
    np.testing.assert_array_equal(t_cqr._monotonicity_box(wide), j_cqr._monotonicity_box(wide))


_EXACT = {
    "three_quantiles": (0.025, 0.5, 0.975),
    "interval": (0.05, 0.95),
    "single_quantile": (0.3,),
    "seven_quantiles": (0.025, 0.05, 0.1, 0.5, 0.9, 0.95, 0.975),
}


@pytest.mark.parametrize("case", sorted(_EXACT))
def test_exact_lp_matches_jax(case: str) -> None:
    """Same LP, same HiGHS: rtol 1e-9."""
    quantiles = _EXACT[case]
    X, y, w = _problem(3)
    ours = t_cqr.CoherentLinearQuantileRegressor(quantiles=quantiles, method="exact").fit(X, y, sample_weight=w)
    theirs = j_cqr.CoherentLinearQuantileRegressor(quantiles=quantiles, method="exact").fit(X, y, sample_weight=w)
    np.testing.assert_allclose(ours.β_, theirs.β_, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.β_full_, theirs.β_full_, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.intercept_clip(X, y), theirs.intercept_clip(X, y), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.predict(X), theirs.predict(X), rtol=1e-9, atol=1e-12)
    assert ours.solver_diagnostics_ == theirs.solver_diagnostics_
    assert ours.predict(X).shape == ((len(X),) if len(quantiles) == 1 else (len(X), len(quantiles)))


def test_exact_lp_needs_no_device() -> None:
    """The exact path is host code: the default device="cuda" is never resolved."""
    X, y, w = _problem(4, n=120)
    model = t_cqr.CoherentLinearQuantileRegressor(quantiles=(0.1, 0.9), method="exact")
    assert model.device == "cuda"
    assert np.all(np.diff(model.fit(X, y, sample_weight=w).predict(X), axis=1) >= -1e-9)


def test_smooth_solver_runs_on_the_card_unless_asked_for_the_cpu() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device='cuda' is valid here")
    X, y, w = _problem(4, n=120)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cqr.CoherentLinearQuantileRegressor(quantiles=(0.1, 0.9), method="smooth").fit(X, y, sample_weight=w)


def _stage_operands(seed: int = 5, n: int = 200, Q: int = 5):
    gen = np.random.RandomState(seed)
    X = np.hstack([gen.randn(n, 2), np.ones((n, 1))])
    y = X[:, 0] * 0.5 + 0.3 * gen.randn(n)
    q = np.linspace(0.1, 0.9, Q)
    s = gen.rand(n) + 0.5
    s /= s.sum()
    B0 = 0.1 * gen.randn(3, Q)
    X_mono = np.vstack([X, j_cqr._monotonicity_box(X)])
    return B0, X, y, q, s, X_mono


@pytest.mark.parametrize("eps,penalty", [(0.3, 1e2), (3e-4, 3e5)])
def test_smoothed_objective_gradient_and_hessian_match_jax(eps: float, penalty: float) -> None:
    """The objective and its ``torch.func`` derivatives through the softplus and
    √(B² + 1e-12), against ``jax.grad`` and ``jax.hessian``: rtol 1e-10."""
    B0, X, y, q, s, X_mono = _stage_operands()
    alpha = 1e-9
    t_args = [torch.from_numpy(a) for a in (X, y, q, s)]
    t_mono = torch.from_numpy(X_mono)

    def f_t(flat):
        return t_cqr._smoothed_objective(flat.reshape(B0.shape), *t_args, alpha, eps, penalty, t_mono)

    def f_j(flat):
        return j_cqr._smoothed_objective(
            flat.reshape(B0.shape), *(jnp.asarray(a) for a in (X, y, q, s)), alpha, eps, penalty, jnp.asarray(X_mono)
        )

    flat_t, flat_j = torch.from_numpy(B0.reshape(-1)), jnp.asarray(B0.reshape(-1))
    np.testing.assert_allclose(f_t(flat_t).numpy(), np.asarray(f_j(flat_j)), rtol=1e-12)
    np.testing.assert_allclose(
        torch.func.grad(f_t)(flat_t).numpy(), np.asarray(jax.grad(f_j)(flat_j)), rtol=1e-10, atol=1e-14
    )
    np.testing.assert_allclose(
        torch.func.hessian(f_t)(flat_t).numpy(), np.asarray(jax.hessian(f_j)(flat_j)), rtol=1e-10, atol=1e-12
    )


def test_one_newton_stage_matches_jax() -> None:
    """Five damped Newton steps from the same start, alone and under ``vmap``: rtol 1e-8."""
    B0, X, y, q, s, X_mono = _stage_operands(seed=6)
    theirs = np.asarray(
        j_cqr._newton_stage(
            *(jnp.asarray(a) for a in (B0, X, y, q, s)), jnp.asarray(1e-9), jnp.asarray(0.3), jnp.asarray(1e2),
            jnp.asarray(X_mono), num_steps=5,
        )
    )
    t = [torch.from_numpy(a) for a in (B0, X, y, q, s)]
    ours = t_cqr._newton_stage(*t, 1e-9, 0.3, 1e2, torch.from_numpy(X_mono), num_steps=5)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-8, atol=1e-12)
    batched = torch.func.vmap(
        lambda b, y_t, s_t: t_cqr._newton_stage(b, t[1], y_t, t[3], s_t, 1e-9, 0.3, 1e2, torch.from_numpy(X_mono), num_steps=5)
    )(torch.stack([t[0], t[0]]), torch.stack([t[2], t[2]]), torch.stack([t[4], t[4]]))
    np.testing.assert_allclose(batched[1].numpy(), theirs, rtol=1e-8, atol=1e-12)


def test_exact_pinball_matches_jax() -> None:
    gen = np.random.RandomState(8)
    B, X, Y = gen.randn(2, 3, 5), gen.randn(40, 3), gen.randn(2, 40)
    q, S = np.linspace(0.1, 0.9, 5), gen.rand(2, 40)
    ours = t_cqr._exact_pinball_device(*(torch.from_numpy(a) for a in (B, X, Y, q, S)))
    theirs = j_cqr._exact_pinball_device(*(jnp.asarray(a) for a in (B, X, Y, q, S)))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-12)


_SMOOTH = {
    "interval_with_intercept": ((0.05, 0.95), True, 11),
    "three_quantiles_with_intercept": ((0.025, 0.5, 0.975), True, 12),
    "single_quantile": ((0.4,), True, 13),
    "no_intercept": ((0.1, 0.9), False, 14),
}


@pytest.mark.parametrize("case", sorted(_SMOOTH))
def test_smooth_solver_matches_jax(case: str) -> None:
    """The whole continuation in float64: ``β_full_`` at rtol 1e-5 (atol 1e-7 on the
    coefficients the L1 term drives to zero). A near-tie among the candidate steps may part
    the iterates in the last digits, so the optimum itself is held too: the exact pinball
    loss at rtol 1e-8 and the predictions at 1e-6."""
    quantiles, fit_intercept, seed = _SMOOTH[case]
    X, y, w = _problem(seed, n=240)
    kw = {"quantiles": quantiles, "method": "smooth", "fit_intercept": fit_intercept}
    ours = t_cqr.CoherentLinearQuantileRegressor(device="cpu", **kw).fit(X, y, sample_weight=w)
    theirs = j_cqr.CoherentLinearQuantileRegressor(**kw).fit(X, y, sample_weight=w)
    np.testing.assert_allclose(ours.β_full_, theirs.β_full_, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours.β_, theirs.β_, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours.predict(X), theirs.predict(X), rtol=1e-6, atol=1e-7)
    assert ours.solver_diagnostics_["stages"] == theirs.solver_diagnostics_["stages"]
    np.testing.assert_allclose(ours.solver_diagnostics_["pinball"], theirs.solver_diagnostics_["pinball"], rtol=1e-8)
    if fit_intercept:
        np.testing.assert_allclose(
            _pinball(X, y, w, ours.β_, quantiles), _pinball(X, y, w, theirs.β_, quantiles), rtol=1e-8
        )
        np.testing.assert_allclose(ours.intercept_clip(X, y), theirs.intercept_clip(X, y), rtol=1e-5, atol=1e-7)


def test_smooth_solver_comes_within_half_a_percent_of_the_exact_lp() -> None:
    """On a design whose quantile planes do not cross inside the inflated box (parallel
    planes: the noise does not grow with X), where the smooth problem's extra box
    constraints do not bind."""
    quantiles = (0.05, 0.5, 0.95)
    X, _, w = _problem(15, n=240)
    y = 0.3 * X[:, 1] + 0.2 * np.random.RandomState(15).randn(len(X))
    smooth = t_cqr.CoherentLinearQuantileRegressor(quantiles=quantiles, method="smooth", device="cpu").fit(
        X, y, sample_weight=w
    )
    exact = t_cqr.CoherentLinearQuantileRegressor(quantiles=quantiles, method="exact").fit(X, y, sample_weight=w)
    gap = _pinball(X, y, w, smooth.β_, quantiles) / _pinball(X, y, w, exact.β_, quantiles) - 1
    assert -1e-9 <= gap <= 5e-3
    assert np.all(np.diff(smooth.predict(X), axis=1) >= -1e-9)


def test_batched_smooth_solver_matches_jax() -> None:
    """T = 2 targets on one design, as the estimator's smooth conformal lane calls it."""
    X, y, w = _problem(16, n=200)
    X_i = np.hstack([X, np.ones((len(X), 1))])
    Y = np.stack([y, y / np.maximum(np.abs(X[:, 1]), 1e-3)])
    q = np.array([0.05, 0.95])
    ours = t_cqr.coherent_linear_quantile_regression_batched(X_i, Y, quantiles=q, sample_weight=w, device="cpu")
    theirs = j_cqr.coherent_linear_quantile_regression_batched(X_i, Y, quantiles=q, sample_weight=w)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_unknown_method_raises() -> None:
    X, y, w = _problem(17, n=50)
    with pytest.raises(ValueError, match="Unknown method"):
        t_cqr.CoherentLinearQuantileRegressor(method="simplex").fit(X, y, sample_weight=w)
