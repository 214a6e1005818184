"""The plain reference agrees with a fit of the port on the CPU at a tiny size, through the
fit cell's whole run (the timed loop, the comparison), and its pieces are right alone."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import lssvm, normalizer, separator

CPU = torch.device("cpu")
# The port on the CPU runs the kernels' plain versions: float32 rows agree with float64 to
# float32's rounding grown by the sums over rows and the solve; float64 rows to float64's.
F32 = {"scale_err": 1e-6, "sep_err": 1e-4, "fold_err": 1e-4, "gram_err": 1e-5, "eig_err": 1e-4,
       "sweep_err": 1e-4, "beta_err": 1e-4, "resid_err": 1e-4}
F64 = {"scale_err": 1e-12, "sep_err": 1e-10, "fold_err": 1e-10, "gram_err": 1e-12, "eig_err": 1e-10,
       "sweep_err": 1e-10, "beta_err": 1e-10, "resid_err": 1e-8, "loo_err": 1e-8}
TINY = {"higgs.fit": F32, "msd.fit": F64}


def tiny_run(name: str, n: int = 3000, seconds: float = 0.5) -> dict:
    """A whole run of the cell on the CPU at ``n`` training rows."""
    cell = harness.load_cell(name)
    cell.config.update(n_train=n, n_test=256)
    return harness.run_cell(cell, 2**31 + 99, seconds, False, CPU)


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_tiny_cpu_run_agrees_with_the_reference(name, small_streaming_fits):
    out = tiny_run(name)
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in harness.load_cell(name).end_to_end}
    assert set(out["metrics"]) == e2e and all(m["value"] > 0 for m in out["metrics"].values())
    for number, tolerance in TINY[name].items():
        assert out["compared"][number]["value"] <= tolerance, number


def test_median_is_the_average_of_the_lower_and_upper_ecdf_interpolations():
    rng = np.random.default_rng(0)
    for m in (1, 2, 5, 6, 101):
        v = rng.normal(size=m)
        w = rng.uniform(0.5, 2.0, size=m)
        order = np.argsort(v)
        cw = np.cumsum(w[order])
        expected = 0.5 * (np.interp(0.5, (cw - w[order]) / cw[-1], v[order]) + np.interp(0.5, cw / cw[-1], v[order]))
        got = float(normalizer.weighted_quantile(torch.from_numpy(v), torch.from_numpy(w), 0.5))
        assert got == pytest.approx(expected, rel=1e-12)
    assert float(normalizer.weighted_quantile(torch.tensor([1.0, 3.0]), torch.ones(2), 0.5)) == 2.0


def test_regression_bins_are_equal_mass():
    y = torch.from_numpy(np.random.default_rng(1).permutation(8000).astype(np.float64))
    codes, bins = normalizer.target_codes(y, is_classifier=False)
    assert bins == 8 and np.bincount(codes.numpy()).tolist() == [1000] * 8


def test_the_reference_solves_the_regularised_system():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 3))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=400)
    M, b = rng.normal(size=(3, 8)), rng.uniform(0, 2 * np.pi, size=8)
    gammas = lssvm.gamma_grid(np.float64, num=16)
    fit = lssvm.Fit(X, y, M, b, gammas, is_classifier=False, mode="f64", device=CPU, block=64)
    # β from the normal equations of the complex problem, in the real embedding: the
    # predictions W·Jβ of the re-solve equal those of a dense least-squares solve.
    U = X @ M + b
    phi = np.concatenate([np.exp(-1j * U) / np.sqrt(8), np.ones((400, 1))], axis=1)
    A = phi.conj().T @ phi / 400**2
    i = 5
    beta = np.linalg.solve(A + gammas[i] / (400 * 9) * np.eye(9), phi.conj().T @ y / 400**2)
    swept = fit.sweep(fit.operands(), i)
    np.testing.assert_allclose(swept["residuals"], (phi @ beta).real - y, atol=1e-9)
    # The LOO prediction of row j is the fit on the other rows at j: ŷ_j − e_j(1 − h_j) …
    # here, by brute force, the dense solve without row j.
    for j in (0, 17):
        keep = np.arange(400) != j
        A_j = phi[keep].conj().T @ phi[keep] / 400**2
        beta_j = np.linalg.solve(A_j + gammas[i] / (400 * 9) * np.eye(9), phi[keep].conj().T @ y[keep] / 400**2)
        assert swept["loo_yhat"][j] == pytest.approx((phi[j] @ beta_j).real, rel=1e-8)


def test_the_draws_are_the_estimators():
    from neo_ls_svm_torch.ops import pretransform_device  # noqa: PLC0415

    setting = {"seed": 42, "num_features": 40, "edge_sample_size": 12, "edge_search_multiplier": 3, "rank_threshold": 2e-2}
    for is_classifier, num_bins in ((True, 2), (False, 8)):
        shapes = pretransform_device.draw_shapes(
            5, num_bins=num_bins, num_features=40, edge_sample_size=12, edge_search_multiplier=3,
            is_classifier=is_classifier,
        )
        generator = torch.Generator(device=CPU)
        generator.manual_seed(42)
        theirs = pretransform_device.draw_pretransform_inputs(generator, shapes, torch.float32, CPU)
        ours = separator.draw(42, d=5, num_bins=num_bins, setting=setting, is_classifier=is_classifier,
                              dtype=torch.float32, device=CPU)
        assert set(ours) == set(theirs)
        for name in ours:
            assert torch.equal(ours[name], theirs[name]), name


def test_columns_align_up_to_sign():
    R = np.random.default_rng(3).normal(size=(6, 4))
    signs = np.array([1.0, -1.0, -1.0, 1.0])
    assert separator.columns_up_to_sign(R * signs, R).tolist() == signs.tolist()


def test_a_separator_is_held_free_of_signs_and_turns_within_repeated_eigenvalues():
    # One bin of d = 3 with a repeated eigenvalue: any basis of that plane passes, in any sign.
    G = np.diag([4.0, 1.0, 1.0])
    ref = {"edge_gram": G[None], "eig": np.array([[4.0, 1.0, 1.0]]), "keep": np.ones((1, 3)), "lam": np.array(2.0)}
    c, s = np.cos(0.3), np.sin(0.3)
    A = 2.0 * np.array([[-1.0, 0, 0], [0, c, -s], [0, s, c]])
    assert separator.separator_error(A, ref) < 1e-15
    assert separator.separator_error(A[:, [1, 0, 2]], ref) > 0.5  # out of rank
    assert separator.separator_error(1.01 * A, ref) == pytest.approx(0.01)  # λ off
    dropped = A.copy()
    dropped[:, 2] = 0.0
    assert separator.separator_error(dropped, ref) == 1.0
