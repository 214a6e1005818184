"""Dual LS-SVM solver with closed-form leave-one-out γ tuning.

Implements the math of the reference's ``_optimize_α̂_γ`` (ref ``_neo_ls_svm.py:191-325``):
the kernel system (γρS⁻² + K)α̂ = y with K = φφᵀ + 11ᵀ - (1-ρ)/ρ·C, solved through one
EVD of the weighted kernel so that α̂(γ) and the exact LOO predictions for a whole γ grid
follow in closed form (Cawley & Talbot-style virtual LOO; ref derivation ``:229-243``).

The reference materialises an n×G×n tensor H_loo via einsum (``:272-278``). Here the
contraction Σₖ F̃ᵢₖ·H⁽ᵍ⁾ᵢₖ is refactored through the eigenbasis into
``(sQ ∘ (F̃ @ sQ)) @ r``, three n×n products plus n×G products: O(n²) memory instead of
O(n²·G). Counterpart of ``neo_ls_svm_tpu.models.dual``.

Used for n ≤ 1024 (ref ``:375``), so everything is one untiled block on the device. The
products are cuBLAS's, in IEEE float32 or float64 whatever the caller set
(``utils/precision.py``), as the JAX functions' ``precision=HIGHEST``.
"""

import torch

from neo_ls_svm_torch.ops.kernels import rbf_kernel, squared_distances
from neo_ls_svm_torch.ops.loo import clip_classifier_residuals
from neo_ls_svm_torch.utils.precision import matmul_precision

RBF_GAMMA = 0.5  # Fixed kernel width; the metric is learned upstream (ref :257,261).


@matmul_precision("ieee")
def dual_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    gammas: torch.Tensor,
    *,
    rho: float = 1.0,
    is_classifier: bool,
) -> dict[str, torch.Tensor]:
    """Fit the dual LS-SVM on (affine-transformed) X and tune γ by closed-form LOO."""
    n = X.shape[0]
    dtype = X.dtype
    eps = torch.finfo(dtype).eps
    s = sample_weight / sample_weight.sum()
    # The median that averages the two middle values of an even-length vector
    # (torch.median returns the lower one).
    sn = s / torch.quantile(s.abs(), 0.5)

    K_rbf = rbf_kernel(X, X, RBF_GAMMA, same=True)
    F = K_rbf + 1.0  # φφᵀ + 11ᵀ: the rank-1 bias term rides the kernel (ref :261).
    if rho != 1.0:
        # Surface-complexity regulariser; inert at the shipped default ρ=1 (ref :256-263).
        sq = squared_distances(X, X, same=True)
        C = torch.sqrt(K_rbf) * (1.0 - sq * (RBF_GAMMA / X.shape[1]))
        K = F - (1.0 - rho) / rho * C
    else:
        K = F
    lam, Q = torch.linalg.eigh(sn[:, None] * K * sn[None, :])
    sQ = sn[:, None] * Q
    alpha_basis = sQ * (Q.T @ (sn * y))[None, :]

    # LOO sweep over the γ grid, all in the eigenbasis.
    r = 1.0 / (gammas[None, :] * rho + lam[:, None])  # n × G resolvent columns.
    F_od = F * (1.0 - torch.eye(n, dtype=dtype, device=X.device))  # Off-diagonal F (ref :283-284).
    P = sQ * (F_od @ sQ)  # (sQ ∘ F̃sQ): Σₖ F̃ᵢₖ H⁽ᵍ⁾ᵢₖ basis.
    cross = P @ r  # n × G
    hdiag = (sQ * sQ) @ r  # diag(H⁽ᵍ⁾), n × G
    hdiag = torch.where(hdiag == 0, torch.full_like(hdiag, eps), hdiag)
    alpha_loo = alpha_basis @ r  # α̂(γ) columns, n × G
    yhat_loo = (-cross / hdiag) * alpha_loo + (F_od @ alpha_basis) @ r
    loo_residuals = clip_classifier_residuals(yhat_loo - y[:, None], y, is_classifier)
    abs_e = loo_residuals.abs()
    loo_errors_gs = s @ abs_e
    if is_classifier:
        objective = s @ (abs_e >= 1).to(dtype) + s @ (abs_e - 1).clamp_min(0.0) + loo_errors_gs
    else:
        objective = loo_errors_gs
    optimum = torch.argmin(objective)
    gamma_opt = gammas[optimum]

    e_opt = loo_residuals[:, optimum]
    yhat_loo_opt = yhat_loo[:, optimum]  # Pre-clip LOO predictions feed loo_score_.
    if is_classifier:
        loo_score = s @ (torch.sign(yhat_loo_opt) == y).to(dtype)
    else:
        y_mean = s @ y
        resid = yhat_loo_opt - y
        loo_score = 1.0 - (s @ (resid * resid)) / (s @ ((y - y_mean) * (y - y_mean)))

    # Re-solve (γρ·diag(sn⁻²) + K)α̂ = y via Cholesky for accuracy (ref :313-314).
    L = torch.linalg.cholesky(K + torch.diag(gamma_opt * rho / (sn * sn)))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    residuals = clip_classifier_residuals(F @ alpha - y, y, is_classifier)

    # Predictive variance σ²(x) = 1 - k(x,X)(LLᵀ)⁻¹k(X,x) on the train points (ref :321-323).
    sigma2 = 1.0 - (K_rbf * torch.cholesky_solve(K_rbf.T, L).T).sum(dim=1)

    return {
        "alpha": alpha,
        "gamma": gamma_opt,
        "optimum_index": optimum,
        "chol": L,
        "loo_errors_gammas": loo_errors_gs,
        "loo_residuals": e_opt,
        "loo_yhat": y + e_opt,
        "loo_error": loo_errors_gs[optimum],
        "loo_score": loo_score,
        "loo_std": torch.sqrt(sigma2),
        "residuals": residuals,
    }


@matmul_precision("ieee")
def dual_decision_function(X: torch.Tensor, X_train: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """ŷ(x) = k(x, X)α̂ + 1ᵀα̂ (ref ``:666-671``)."""
    return rbf_kernel(X, X_train, RBF_GAMMA) @ alpha + alpha.sum()


@matmul_precision("ieee")
def dual_decision_var(
    X: torch.Tensor, X_train: torch.Tensor, alpha: torch.Tensor, chol: torch.Tensor
) -> torch.Tensor:
    """ŷ(x) and σ²(x) stacked (n, 2), sharing one RBF kernel block ``k(x, X)`` (ref
    ``:666-671`` and ``:471-475``)."""
    K = rbf_kernel(X, X_train, RBF_GAMMA)
    yhat = K @ alpha + alpha.sum()
    var = 1.0 - (K * torch.cholesky_solve(K.T, chol).T).sum(dim=1)
    return torch.stack([yhat, var], dim=1)


@matmul_precision("ieee")
def dual_predict_var(X: torch.Tensor, X_train: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """σ²(x) = K(x,x) - k(x,X)(LLᵀ)⁻¹k(X,x) (ref ``:471-475``)."""
    K = rbf_kernel(X, X_train, RBF_GAMMA)
    return 1.0 - (K * torch.cholesky_solve(K.T, chol).T).sum(dim=1)
