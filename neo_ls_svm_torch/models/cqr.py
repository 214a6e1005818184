"""Coherent linear quantile regression — the conformal-calibration engine.

The reference formulates joint multi-quantile regression with monotone ("coherent")
predictions as one sparse LP over ~2Q(F+n) variables and ships it to SciPy's HiGHS
(ref ``_coherent_linear_quantile_regressor.py:23-179``).

Two solver paths, selected by ``method``:

- ``"exact"`` (default for conformal-sized problems): an exact LP solved by HiGHS on
  the host. The formulation differs from the reference's (a β = β⁺ − β⁻ positive split
  carries the L1 term instead of auxiliary t = |β| variables; same optimum) but solves
  the *same* optimization problem, so the fitted coefficients hit the LP optimum the
  reference hits. The conformal problems are tiny (F ≤ 3, n ≤ 1440), so the host solve
  happens once per quantile tuple.
- ``"smooth"`` (default at scale): eliminate the LP's residual splits Δ⁺/Δ⁻
  analytically — they are the positive/negative parts of r = Xβ − y — leaving a tiny
  problem in the Q·F regression coefficients only:

      min_B  Σⱼ (1/Q) Σᵢ sᵢ · ρ_{qⱼ}(yᵢ - xᵢᵀβⱼ)  +  α‖B‖₁
      s.t.   Xβⱼ ≤ Xβⱼ₊₁                                      (monotonicity)

  solved on ``device`` by damped Newton on a smoothed pinball loss with an exterior
  quadratic-hinge penalty for the constraints, under an (ε, c)-continuation schedule.
  Exact training-set monotonicity is then restored by a cumulative intercept repair.

``intercept_clip`` semantics are reproduced exactly (ref ``:257-272``).

PyTorch port of ``neo_ls_svm_torch.models.cqr``. The host code (the LPs, the standardisation,
the seeding and the intercept repair) is a copy; the Newton stages are ``torch.func``
programs (``grad``, ``hessian``, ``vmap``) on the solver's device, in float64 always (the
JAX solver follows its x64 flag).
"""

import os
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.utils.base import BaseEstimator, RegressorMixin
from neo_ls_svm_torch.utils.device import resolve_device, to_device
from neo_ls_svm_torch.utils.validation import (
    check_array,
    check_is_fitted,
    check_sample_weight,
    check_X_y,
)
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile


def _extend_quantiles(quantiles: npt.NDArray, coherence_buffer: int) -> npt.NDArray:
    """Insert ``coherence_buffer`` auxiliary ranks between each requested pair
    (ref ``:77-82``)."""
    return np.interp(
        np.linspace(0, len(quantiles) - 1, (len(quantiles) - 1) * (1 + coherence_buffer) + 1),
        np.arange(len(quantiles)),
        quantiles,
    ).astype(quantiles.dtype)


def _monotonicity_box(Xs: npt.NDArray, margin: float = 1.0, max_corners: int = 1024) -> npt.NDArray:
    """Vertices of an inflated bounding box of the (standardised) design matrix.

    An affine function is monotone over a box iff it is monotone at the box's vertices,
    so constraining the quantile planes at these corners guarantees coherent predictions
    for every input inside the inflated box — a *stronger* guarantee than the reference
    LP, which constrains training rows only and can cross just outside them. Above
    ~log2(max_corners) varying features the full vertex set is intractable and a fixed
    random sample of sign patterns is used instead, which demotes the box guarantee to a
    sampled one (training-row monotonicity is still restored exactly by the intercept
    repair either way).
    """
    lo, hi = Xs.min(axis=0), Xs.max(axis=0)
    span = hi - lo
    lo, hi = lo - margin * span, hi + margin * span
    varying = np.flatnonzero(span > 1e-12)
    if len(varying) > int(np.log2(max_corners)):
        # Too many dimensions to enumerate: sample sign patterns instead.
        gen = np.random.RandomState(0)
        signs = gen.randint(0, 2, size=(max_corners, len(varying)))
    else:
        signs = (
            (np.arange(2 ** len(varying))[:, None] >> np.arange(len(varying))[None, :]) & 1
        )
    corners = np.repeat(Xs[:1], signs.shape[0], axis=0)
    corners[:, varying] = np.where(signs == 1, hi[varying], lo[varying])
    return corners


def _solve_coupled_lp(
    X: npt.NDArray,
    y: npt.NDArray,
    quantiles_full: npt.NDArray,
    s: npt.NDArray,
    alpha: float,
    _equilibrated: bool = False,
) -> npt.NDArray:
    """Exact coherent-quantile LP over a (sub)set of quantiles, solved by HiGHS.

    Same optimization problem as the reference LP (ref
    ``_coherent_linear_quantile_regressor.py:91-173``) in a different formulation:

    - variables z = [β⁺, β⁻, Δ⁺, Δ⁻], all ≥ 0 (linprog's default bound), with
      β = β⁺ − β⁻; the L1 term is α·1ᵀ(β⁺ + β⁻), which equals α‖β‖₁ at any optimum
      because one of each pair is driven to zero — replacing the reference's auxiliary
      t = |β| variables and their 2QF inequality rows,
    - residual split  Xβⱼ − y = Δⱼ⁺ − Δⱼ⁻  with pinball objective
      Σⱼ (1/Q)·sᵀ[(1−qⱼ)Δⱼ⁺ + qⱼΔⱼ⁻],
    - monotonicity  Xβⱼ ≤ Xβⱼ₊₁  expressed on the residual splits:
      (Δⱼ⁺ − Δⱼ⁻) − (Δⱼ₊₁⁺ − Δⱼ₊₁⁻) ≤ 0.

    Returns β with one row per feature and one column per quantile passed in.
    """
    from scipy import sparse
    from scipy.optimize import linprog

    n, F = X.shape
    Q = len(quantiles_full)
    dtype = np.float64  # HiGHS works in f64 regardless; build in f64 for conditioning.
    q = quantiles_full.astype(dtype)
    Xd = X.astype(dtype)
    sd = s.astype(dtype)

    c = np.concatenate(
        [
            np.full(2 * Q * F, alpha, dtype=dtype),  # β⁺ then β⁻
            np.kron((1.0 - q) / Q, sd),  # Δ⁺ (over-prediction)
            np.kron(q / Q, sd),  # Δ⁻ (under-prediction)
        ]
    )
    X_blocks = sparse.kron(sparse.eye(Q, dtype=dtype), sparse.csr_matrix(Xd))
    I_Qn = sparse.eye(Q * n, dtype=dtype)
    A_eq = sparse.hstack([X_blocks, -X_blocks, -I_Qn, I_Qn], format="csr")
    b_eq = np.tile(y.astype(dtype), Q)
    if Q > 1:
        # Monotonicity on consecutive quantiles via the residual splits.
        D = sparse.kron(
            sparse.diags([1.0, -1.0], offsets=[0, 1], shape=(Q - 1, Q), dtype=dtype),
            sparse.eye(n, dtype=dtype),
        )
        Z_beta = sparse.csr_matrix(((Q - 1) * n, 2 * Q * F), dtype=dtype)
        A_ub = sparse.hstack([Z_beta, D, -D], format="csr")
        b_ub = np.zeros((Q - 1) * n, dtype=dtype)
    else:  # A single quantile has no coherence constraints.
        A_ub, b_ub = None, None
    # Interior point (with HiGHS's default crossover to a vertex) is ~2-3x faster than
    # dual simplex on this constraint structure and reaches the same optimum.
    result = linprog(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, method="highs-ipm")
    if not result.success:
        # This LP cannot genuinely fail: c ≥ 0 and x ≥ 0 bound the objective below by
        # 0, and Δ⁺−Δ⁻ = Xβ−y is satisfiable for any β, so it is feasible AND bounded.
        # HiGHS nevertheless misreports instances whose coefficients span ~20 orders
        # of magnitude (observed: |X| ~1e12 with α ~5e-9 → "unbounded" from every
        # HiGHS method). Retry once on a column-equilibrated formulation: solving in
        # x̃ = x/colmax, ỹ = y/max|y| divides each pinball term by max|y|, so the
        # argmin is unchanged up to the √eps-tiny L1 tie-breaker becoming
        # column-weighted; β unscales as β = max|y|·β̃/colmax. The primary
        # (reference-parity) path is untouched — this only engages where the raw
        # solve returned no solution at all.
        if not _equilibrated:
            col = np.abs(Xd).max(axis=0)
            col = np.where(col > 0, col, 1.0)
            y_scale = max(float(np.abs(y).max()), np.finfo(dtype).tiny)
            beta_eq = _solve_coupled_lp(
                Xd / col[None, :], y / y_scale, quantiles_full, s, alpha, _equilibrated=True
            )
            return beta_eq * (y_scale / col[:, None])
        msg = f"Coherent quantile LP failed: {result.message}"
        raise RuntimeError(msg)
    beta = result.x[: Q * F] - result.x[Q * F : 2 * Q * F]
    return beta.reshape(Q, F).T


# Kill switch for the monotone block decomposition below (tests flip it to compare the
# decomposed optimum against the one-shot coupled LP).
_LP_DECOMPOSITION = True


def _solve_exact_lp(
    X: npt.NDArray,
    y: npt.NDArray,
    quantiles_full: npt.NDArray,
    s: npt.NDArray,
    alpha: float,
    stats: dict | None = None,
) -> npt.NDArray:
    """Exact coherent-quantile solve via monotone block decomposition.

    The coupled LP's only interaction between quantiles is the chain of monotonicity
    constraints Xβⱼ ≤ Xβⱼ₊₁; everything else (pinball + L1) is separable per
    quantile. Dropping a subset of chain links is a relaxation, so for ANY partition
    of the quantiles into contiguous blocks,

        OPT(coupled) ≥ Σ_blocks OPT(block subproblem with intra-block links only),

    and if the per-block optima happen to satisfy the dropped cross-block links on the
    training rows, the concatenated solution is feasible for the coupled LP and attains
    the relaxation bound — i.e. it IS a global optimum. This function exploits that:

    1. solve the Q single-quantile LPs (each ~Q× smaller; HiGHS solves the whole set
       an order of magnitude faster than the coupled LP — 0.9 s vs 29 s at the
       conformal size Q=17, n=1440),
    2. check the chain on the training rows; on conformal designs (residual quantiles
       vs nonconformity) the independent planes are monotone essentially always,
    3. if any adjacent pair crosses, merge the offending blocks pool-adjacent-violators
       style and re-solve just those as coupled LPs, repeating until the chain holds —
       worst case one block remains and this degenerates to the original full LP.

    α is rescaled per block (α·Q/Q_block) so each block objective is a positive
    multiple of the full objective's restriction, preserving the argmin.

    Returns β_full with one row per feature and one column per (extended) quantile.
    """
    Q = len(quantiles_full)
    if not _LP_DECOMPOSITION or Q == 1:
        return _solve_coupled_lp(X, y, quantiles_full, s, alpha)

    blocks = [(j, j + 1) for j in range(Q)]  # contiguous [lo, hi) quantile-index ranges
    betas: dict[tuple[int, int], npt.NDArray] = {}

    def solve_block(block: tuple[int, int]) -> None:
        lo, hi = block
        alpha_block = alpha * Q / (hi - lo)
        betas[block] = _solve_coupled_lp(X, y, quantiles_full[lo:hi], s, alpha_block)

    # HiGHS releases the GIL during the solve, so the independent per-quantile LPs
    # parallelise across host cores (a no-op on 1-core hosts, ~min(Q, cores)× there).
    workers = min(Q, os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(solve_block, blocks))
    else:
        for block in blocks:
            solve_block(block)
    merge_rounds = 0
    Xd = X.astype(np.float64)
    while True:
        beta_full = np.hstack([betas[b] for b in blocks])
        P = Xd @ beta_full  # (n, Q) fitted quantile surfaces on the training rows
        # Intra-block pairs are feasible to HiGHS's primal tolerance; only block
        # boundaries can genuinely cross. Boundary acceptance is tighter than the
        # monotonicity contract downstream consumers assert (diff ≥ -1e-9): on real
        # conformal designs the independent optima are monotone with ≥1e-5 margins,
        # so a tight tolerance costs nothing and degenerate near-ties merge instead.
        tol = 1e-9 * max(1.0, float(np.abs(P).max()))
        crossed = (P[:, :-1] - P[:, 1:]).max(axis=0) > tol  # pair j ↔ (j, j+1)
        if not any(crossed[b[1] - 1] for b in blocks[:-1]):
            break
        merged: list[tuple[int, int]] = [blocks[0]]
        for block in blocks[1:]:
            prev = merged[-1]
            if crossed[prev[1] - 1]:  # boundary between prev's last and block's first
                merged[-1] = (prev[0], block[1])
            else:
                merged.append(block)
        blocks = merged
        merge_rounds += 1
        for block in blocks:
            if block not in betas:
                solve_block(block)
    if stats is not None:
        stats.update({"lp_blocks": len(blocks), "lp_merge_rounds": merge_rounds})
    return np.hstack([betas[b] for b in blocks])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as max(x, 0) + log1p(e^(−|x|)): stable at any x, and twice
    differentiable by ``torch.func`` in both modes. (``torch.nn.functional.softplus``
    switches to x itself above a threshold, which would move the optimum.)"""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _smoothed_objective(
    B: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    q: torch.Tensor,
    s: torch.Tensor,
    alpha: float,
    eps: float,
    penalty: float,
    X_mono: torch.Tensor,
) -> torch.Tensor:
    """Smoothed pinball + L1 + quadratic-hinge monotonicity penalty; C¹."""
    pred = X @ B  # n × Q
    r = y[:, None] - pred
    # Smoothed check function: ρ_q(r) ≈ q·r + ε·softplus(-r/ε) → exact pinball as ε→0.
    pinball = q[None, :] * r + eps * _softplus(-r / eps)
    loss = torch.sum(s[:, None] * pinball) / q.shape[0]
    loss = loss + alpha * torch.sum(torch.sqrt(B * B + 1e-12))
    if B.shape[1] > 1:  # single-quantile fits have no pairs to order (and the
        # mean over the empty violation array would be NaN, silently vetoing
        # every Newton step via the backtracking comparison)
        pred_mono = X_mono @ B
        violation = torch.clamp(pred_mono[:, :-1] - pred_mono[:, 1:], min=0.0)
        loss = loss + penalty * torch.mean(violation * violation)
    return loss


def _newton_stage(
    B0: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    q: torch.Tensor,
    s: torch.Tensor,
    alpha: float,
    eps: float,
    penalty: float,
    X_mono: torch.Tensor,
    *,
    num_steps: int,
) -> torch.Tensor:
    """Damped Newton with vectorised backtracking on the flattened coefficients.

    Written for one target; ``torch.func.vmap`` maps it over stacked targets. Nothing in
    it reads a tensor's value on the host.
    """
    shape = B0.shape
    dim = B0.numel()

    def f(flat: torch.Tensor) -> torch.Tensor:
        return _smoothed_objective(flat.reshape(shape), X, y, q, s, alpha, eps, penalty, X_mono)

    grad_f = torch.func.grad(f)
    hess_f = torch.func.hessian(f)
    values_f = torch.func.vmap(f)
    # Step size 0 rides along so f(flat) comes out of the same vmapped evaluation
    # (values[0]) instead of a separate full objective pass per Newton step. The
    # range reaches 2⁻²⁹: in curvature-free regions (all residuals one-sided, H ≈
    # damping·I) the Newton direction is a huge rescaled gradient, and only a deep
    # backtrack turns it into a useful damped-gradient step — with a shallow
    # 2⁻¹¹ floor every candidate overshoots and the solver stalls at its seed on
    # uncentered no-intercept problems.
    step_sizes = torch.cat(
        [
            torch.zeros(1, dtype=B0.dtype, device=B0.device),
            2.0 ** -torch.arange(0, 30, dtype=B0.dtype, device=B0.device),
        ]
    )
    eye = torch.eye(dim, dtype=B0.dtype, device=B0.device)
    flat = B0.reshape(-1)
    for _ in range(num_steps):
        g = grad_f(flat)
        H = hess_f(flat)
        # Levenberg damping keeps H positive definite through the hinge kinks.
        damping = 1e-7 * (1.0 + torch.diagonal(H).sum() / dim)
        # cholesky_ex reports a failed factorisation in `info` instead of raising, which
        # would read the device; a failed step is then refused below.
        L, info = torch.linalg.cholesky_ex(H + damping * eye)
        direction = torch.cholesky_solve(g[:, None], L)[:, 0]
        candidates = flat[None, :] - step_sizes[:, None] * direction[None, :]
        values = values_f(candidates)
        # The first minimum among the 30 real steps, as jnp.argmin.
        best = torch.argmin(values[1:], dim=0, keepdim=True) + 1
        improved = (torch.gather(values, 0, best)[0] < values[0]) & (info == 0)
        chosen = torch.gather(candidates, 0, best[:, None].expand(1, dim))[0]
        flat = torch.where(improved, chosen, flat)
    return flat.reshape(shape)


def _exact_pinball_device(
    B: torch.Tensor,  # (T, F, Q)
    X: torch.Tensor,  # (n, F)
    Y: torch.Tensor,  # (T, n)
    q: torch.Tensor,  # (Q,)
    S: torch.Tensor,  # (T, n) normalised weights
) -> torch.Tensor:
    """Mean (over targets) exact pinball loss of the current coefficients; scalar."""
    pred = torch.einsum("nf,tfq->tnq", X, B)
    r = Y[:, :, None] - pred
    per_row = torch.maximum(q[None, None, :] * r, (q[None, None, :] - 1.0) * r)
    return torch.mean(torch.einsum("tn,tnq->t", S, per_row) / q.shape[0])


# Above this many LP residual variables (Q·n), HiGHS latency starts to matter and the
# smoothed-Newton path takes over. Conformal problems (Q ≤ 17, n ≤ 1440) are
# far below it.
_EXACT_LP_MAX_SIZE = 200_000


def coherent_linear_quantile_regression(
    X: npt.NDArray,
    y: npt.NDArray,
    *,
    quantiles: npt.NDArray,
    sample_weight: npt.NDArray | None = None,
    coherence_buffer: int = 3,
    method: str = "auto",
    diagnostics: dict | None = None,
    device: "str | torch.device" = "cuda",
) -> tuple[npt.NDArray, npt.NDArray]:
    """Solve the coherent quantile regression problem.

    Returns (β at the requested quantiles, β at all auxiliary quantiles), both with one
    column per quantile and one row per feature — the reference's contract (``:66-72``).

    ``method``: ``"exact"`` (host HiGHS LP, reference-grade optimum), ``"smooth"``
    (damped Newton on the smoothed pinball objective, on ``device``), or ``"auto"``
    (exact for small problems, smooth at scale). ``device`` is read by the smooth path
    only; it defaults to the card, and the CPU is taken only when asked for. Pass a dict as ``diagnostics`` to receive the
    solver's convergence report (smooth path: continuation stages, final smoothing,
    exact-pinball trace; exact path: ``{"solver": "highs"}``).
    """
    num_samples, num_features = X.shape
    quantiles_full = _extend_quantiles(np.asarray(quantiles), coherence_buffer)
    num_quantiles = len(quantiles_full)
    assert np.array_equal(quantiles_full, np.sort(quantiles_full)), "Quantiles must be sorted."
    assert sample_weight is None or np.all(sample_weight >= 0), "Sample weights must be >= 0."
    if method not in ("auto", "exact", "smooth"):
        msg = f"Unknown method {method!r}; expected 'auto', 'exact' or 'smooth'."
        raise ValueError(msg)
    s = np.ones(num_samples, dtype=y.dtype) if sample_weight is None else np.asarray(sample_weight)
    s = s / np.sum(s)
    eps_mach = np.finfo(y.dtype).eps
    alpha = np.sqrt(eps_mach) / (num_quantiles * num_features)  # L1 weight (ref :90).

    if method == "exact" or (method == "auto" and num_quantiles * num_samples <= _EXACT_LP_MAX_SIZE):
        lp_stats: dict = {}
        beta_full = _solve_exact_lp(X, y, quantiles_full, s, alpha, stats=lp_stats)
        if diagnostics is not None:
            diagnostics.update({"solver": "highs", **lp_stats})
        beta = beta_full[:, 0 :: (coherence_buffer + 1)]
        return beta.astype(y.dtype), beta_full.astype(y.dtype)
    beta_full, diag = _solve_smooth_batched(
        X, y[np.newaxis, :], quantiles_full, s[np.newaxis, :], alpha, device
    )
    if diagnostics is not None:
        diagnostics.update({"solver": "smooth_newton", **diag})
    beta_full = beta_full[0]
    beta = beta_full[:, 0 :: (coherence_buffer + 1)]
    return beta.astype(y.dtype), beta_full.astype(y.dtype)


def coherent_linear_quantile_regression_batched(
    X: npt.NDArray,
    Y: npt.NDArray,
    *,
    quantiles: npt.NDArray,
    sample_weight: npt.NDArray | None = None,
    coherence_buffer: int = 3,
    device: "str | torch.device" = "cuda",
) -> tuple[npt.NDArray, npt.NDArray]:
    """Fit T coherent quantile regressions sharing one design matrix in a single
    vmapped Newton solve on ``device`` (the smooth/scale path).

    ``Y`` has shape (T, n). Two consumers: the public multi-target batch API, and
    the estimator's conformal stack under ``NeoLSSVM(conformal_method="smooth")``,
    which solves the "Δŷ" and "Δŷ/ŷ" level-1 regressions as one T=2 batch
    (``models/conformal.py::_fit_conformal_pair``). The default
    ``conformal_method="exact"`` instead takes the exact-LP path, overlapping the
    two HiGHS solves in a 2-thread pool.
    Returns (β, β_full) of shapes (T, F, |quantiles|) and (T, F, Q_full).
    """
    Y = np.atleast_2d(np.asarray(Y))
    num_samples, num_features = X.shape
    quantiles_full = _extend_quantiles(np.asarray(quantiles), coherence_buffer)
    num_quantiles = len(quantiles_full)
    assert np.array_equal(quantiles_full, np.sort(quantiles_full)), "Quantiles must be sorted."
    s = (
        np.ones((Y.shape[0], num_samples), dtype=Y.dtype)
        if sample_weight is None
        else np.broadcast_to(np.asarray(sample_weight), Y.shape).copy()
    )
    s = s / np.sum(s, axis=1, keepdims=True)
    alpha = np.sqrt(np.finfo(Y.dtype).eps) / (num_quantiles * num_features)
    beta_full, _ = _solve_smooth_batched(X, Y, quantiles_full, s, alpha, device)
    beta = beta_full[:, :, 0 :: (coherence_buffer + 1)]
    return beta.astype(Y.dtype), beta_full.astype(Y.dtype)


def _solve_smooth_batched(
    X: npt.NDArray,
    Y: npt.NDArray,  # (T, n) — T target vectors sharing one design matrix
    quantiles_full: npt.NDArray,
    S: npt.NDArray,  # (T, n) — normalised per-target sample weights
    alpha: float,
    device: "str | torch.device" = "cuda",
) -> tuple[npt.NDArray, dict]:
    """Damped-Newton smoothed-pinball solve, vmapped over stacked targets.

    Returns (β_full of shape (T, F, Q), convergence diagnostics). All T fits share
    the standardised design, the monotonicity box, and the continuation schedule; the
    Newton stages (grad, dense Hessian, backtracking) run batched over the targets on
    ``device``, in float64, instead of as T sequential solves.

    The (ε, penalty) continuation is convergence-aware: after the base schedule the
    smoothing keeps sharpening only while the exact (ε=0) pinball loss still
    improves; the diagnostics record the stage count, the final schedule point, and
    the per-stage exact-pinball trace so callers can audit convergence. Measured on
    the conformal-shaped problems, the residual gap to the HiGHS LP optimum is
    ≲0.001% for training-row monotonicity; the advertised ≤0.5% headroom budget is
    the *box* monotonicity guarantee (a strictly more constrained problem than the
    reference LP — see :func:`_monotonicity_box`), not solver error.
    """
    num_samples, num_features = X.shape
    num_quantiles = len(quantiles_full)
    T = Y.shape[0]
    # Standardise for solver conditioning (constant columns — the intercept — keep
    # scale 1); fold the standardisation back into β afterwards.
    x_scale = np.std(X, axis=0)
    x_scale[x_scale < 1e-12] = 1.0
    x_mean = np.mean(X, axis=0)
    # Intercept candidates: constant AND nonzero columns (an all-zero column carries
    # no intercept; selecting one would divide by X[0, col] == 0 below).
    constant_cols = (np.ptp(X, axis=0) < 1e-12) & (np.abs(X[0]) > 1e-12)
    x_mean[constant_cols] = 0.0
    x_scale[constant_cols] = np.abs(X[0, constant_cols])
    if not np.any(constant_cols):
        # Without an intercept column there is nowhere to fold a centering offset back.
        x_mean[:] = 0.0
    Xs = (X - x_mean) / x_scale
    # Likewise the y centering is only foldable through an intercept; the pure y
    # scaling folds back through every coefficient and stays on either way — so the
    # scale is ALWAYS the spread around the median (not the magnitude): the smoothing
    # ε of the continuation schedule is calibrated to unit-scale residuals, and an
    # uncentered target with a large offset would otherwise make ε coarser than the
    # residuals it needs to resolve.
    y_med_true = np.median(Y, axis=1, keepdims=True)  # (T, 1)
    y_med = y_med_true if np.any(constant_cols) else np.zeros((T, 1), dtype=np.float64)
    y_scale = np.maximum(np.median(np.abs(Y - y_med_true), axis=1, keepdims=True), 1e-8)
    Ys = (Y - y_med) / y_scale

    # Initialise every quantile's fit at the weighted empirical quantile (intercepts
    # only), which is already coherent.
    B0 = np.zeros((T, num_features, num_quantiles), dtype=np.float64)
    intercept_col = int(np.argmax(constant_cols)) if np.any(constant_cols) else None
    if intercept_col is not None:
        for t in range(T):
            q_init = weighted_quantile(Ys[t], S[t], quantiles_full, axis=None)
            B0[t, intercept_col, :] = q_init / Xs[0, intercept_col]
    else:
        # No intercept to absorb the target's offset: Newton from zero stalls in the
        # near-flat pinball landscape, so seed every quantile with the weighted
        # least-squares solution (F is tiny; this is a dense F×F solve).
        for t in range(T):
            sw = S[t][:, None] * Xs
            gram = sw.T @ Xs + 1e-10 * np.eye(num_features)
            rhs = sw.T @ Ys[t]
            b_ls = np.linalg.solve(gram, rhs)
            B0[t] = np.repeat(b_ls[:, None], num_quantiles, axis=1)

    dev = resolve_device(device)

    def on_device(a: npt.NDArray) -> torch.Tensor:
        return to_device(a, dev, dtype=np.float64)

    q_dev, X_dev, Y_dev, S_dev = (on_device(a) for a in (quantiles_full, Xs, Ys, S))
    corners = _monotonicity_box(Xs)
    X_mono_np = np.vstack([Xs, corners])
    X_mono = on_device(X_mono_np)
    B = on_device(B0)
    alpha = float(alpha)

    def stage(B_dev: torch.Tensor, eps: float, pen: float) -> torch.Tensor:
        return torch.func.vmap(
            lambda b, y_t, s_t: _newton_stage(
                b, X_dev, y_t, q_dev, s_t, alpha, eps, pen, X_mono, num_steps=20
            )
        )(B_dev, Y_dev, S_dev)

    # (smoothing, penalty) continuation: exterior penalty hardens as the pinball
    # sharpens. The base schedule always runs; the tail stages run only while the
    # exact pinball still improves (convergence-aware early stop).
    base_schedule = ((0.3, 1e2), (0.03, 1e3), (3e-3, 1e4), (3e-4, 3e5))
    tail_schedule = ((3e-5, 1e6), (3e-6, 3e6), (3e-7, 1e7))

    def exact_pinball(B_dev: torch.Tensor) -> float:
        # Runs on the device; only the scalar crosses back, one per stage (the
        # convergence check must not pull B or build a (T, n, Q) host temporary).
        return float(_exact_pinball_device(B_dev, X_dev, Y_dev, q_dev, S_dev))

    trace: list[float] = []
    for eps_rel, penalty in base_schedule:
        B = stage(B, eps_rel, penalty)
    trace.append(exact_pinball(B))
    accepted = base_schedule[-1]
    for eps_rel, penalty in tail_schedule:
        B_next = stage(B, eps_rel, penalty)
        loss = exact_pinball(B_next)
        if loss >= trace[-1] * (1.0 - 1e-7):
            break  # the pinball gap has stalled; stop sharpening
        B = B_next
        accepted = (eps_rel, penalty)
        trace.append(loss)
    diagnostics = {
        "stages": len(base_schedule) + len(trace) - 1,
        "eps_final": accepted[0],
        "penalty_final": accepted[1],
        "pinball_trace": trace,
        "pinball": trace[-1],
    }
    B = B.cpu().numpy()  # (T, F, Q)

    # Undo the standardisation: ŷ = median + y_scale·(Xs @ B) = X @ β + const terms.
    beta_full = (y_scale[:, :, None] * B) / x_scale[None, :, None]
    offset = y_med[:, 0, None] - y_scale[:, 0, None] * np.einsum(
        "f,tfq->tq", x_mean / x_scale, B
    )
    if intercept_col is not None:
        beta_full[:, intercept_col, :] = (
            beta_full[:, intercept_col, :] * x_scale[intercept_col] + offset
        ) / X[0, intercept_col]
        # Exact monotonicity over the inflated box: cumulative intercept repair of any
        # residual violations, evaluated at the box vertices and the training rows.
        X_repair = np.vstack([X, X_mono_np * x_scale[None, :] + x_mean[None, :]])
        for t in range(T):
            pred = X_repair @ beta_full[t]
            gaps = np.max(pred[:, :-1] - pred[:, 1:], axis=0, initial=0.0)
            shift = np.concatenate([[0.0], np.cumsum(np.maximum(gaps, 0.0))])
            beta_full[t, intercept_col, :] += shift / X[0, intercept_col]
    return beta_full, diagnostics


class CoherentLinearQuantileRegressor(RegressorMixin, BaseEstimator):
    """Linear model that regresses multiple quantiles coherently (monotonically).

    API-compatible with the reference estimator
    (``_coherent_linear_quantile_regressor.py:182-272``). ``device`` names where the
    smooth solver runs (the exact LP is host code); it is a resource of the process, not
    fitted state, and a state dict leaves it out.
    """

    def __init__(
        self,
        *,
        quantiles: npt.ArrayLike = (0.025, 0.5, 0.975),
        fit_intercept: bool = True,
        coherence_buffer: int = 3,
        method: str = "auto",
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.quantiles = quantiles
        self.fit_intercept = fit_intercept
        self.coherence_buffer = coherence_buffer
        self.method = method
        self.device = device

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray,
        *,
        sample_weight: npt.NDArray | None = None,
    ) -> "CoherentLinearQuantileRegressor":
        """Fit this predictor."""
        X, y = check_X_y(X, y, y_numeric=True)
        self.n_features_in_: int = X.shape[1]
        self.y_dtype_ = X.dtype if np.issubdtype(y.dtype, np.integer) else y.dtype
        if np.issubdtype(y.dtype, np.datetime64) or np.issubdtype(y.dtype, np.timedelta64):
            X, y = X.astype(np.float64), y.astype(np.float64)
        y = y.astype(X.dtype)
        if sample_weight is not None:
            sample_weight = check_sample_weight(sample_weight, len(y), dtype=y.dtype)
        if self.fit_intercept:
            X = np.hstack([X, np.ones((X.shape[0], 1), dtype=X.dtype)])
        diagnostics: dict = {}
        self.β_, self.β_full_ = coherent_linear_quantile_regression(
            X,
            y,
            quantiles=np.asarray(self.quantiles).astype(y.dtype),
            sample_weight=sample_weight,
            coherence_buffer=self.coherence_buffer,
            method=self.method,
            diagnostics=diagnostics,
            device=self.device,
        )
        self.solver_diagnostics_ = diagnostics
        return self

    def predict(self, X: npt.NDArray) -> npt.NDArray:
        """Predict the quantiles on a given dataset (one column per quantile)."""
        check_is_fitted(self, ["β_"])
        X = check_array(X, dtype=(self.β_.dtype,))
        if X.shape[1] != self.n_features_in_:
            msg = (
                f"X has {X.shape[1]} features, but CoherentLinearQuantileRegressor is "
                f"expecting {self.n_features_in_} features as input."
            )
            raise ValueError(msg)
        if self.fit_intercept:
            X = np.hstack([X, np.ones((X.shape[0], 1), dtype=X.dtype)])
        pred: npt.NDArray = X @ self.β_
        pred = np.squeeze(pred, axis=1 if pred.shape[1] == 1 else ())
        if not np.issubdtype(self.y_dtype_, np.integer):
            pred = pred.astype(self.y_dtype_)
        return pred

    def intercept_clip(self, X: npt.NDArray, y: npt.NDArray) -> npt.NDArray:
        """Bounds on an intercept delta that preserve quantile coherence (ref ``:257-272``)."""
        check_is_fitted(self, ["β_"])
        X, y = check_X_y(X, y, dtype=(self.β_.dtype,), y_numeric=True)
        if self.fit_intercept:
            X = np.hstack([X, np.ones((X.shape[0], 1), dtype=X.dtype)])
        Q = X @ self.β_full_ - y[:, np.newaxis]
        clip = np.vstack(
            [
                np.insert(np.max(Q[:, :-1] - Q[:, 1:], axis=0), 0, -np.inf),
                np.append(np.min(Q[:, 1:] - Q[:, :-1], axis=0), np.inf),
            ]
        )
        clip[:, clip[0, :] >= clip[1, :]] = 0
        return clip[:, 0 :: (self.coherence_buffer + 1)]
