"""Primal LS-SVM solver with closed-form leave-one-out γ tuning, in the real embedding.

PyTorch port of ``neo_ls_svm_tpu.models.primal``. It implements the math of the
reference's ``_optimize_β̂_γ`` (ref ``_neo_ls_svm.py:77-189``):

    β̂(γ) = argmin ‖S(φ(X)β̂ - y)‖² + γ β̂ᴴCβ̂,   C = c₀·I (shipped default)

with the LOO residuals of *every* γ on a grid obtained from one eigendecomposition:

    e⁽ˡᵒᵒ⁾(γ) = (φβ̂(γ) - y) / (1 - h(γ)),   h, φβ̂ rational in γ through Q diag(1/(γ+λ)) Qᴴ

The complex Hermitian system (φ = cos(U)+i·(-sin(U)) features) is carried in its exact
real symmetric embedding E(A) = [[Re A, -Im A], [Im A, Re A]]. For
W = [cos U/√D, 1 | sin U/√D, 0] (n×2M, M = D+1), all four blocks of E(A) come out of one
product WᵀS²W, the eigh is a real symmetric 2M×2M decomposition, and the γ-sweep is two
(n×2M)@(2M×G) contractions evaluated in chunks.

Every function takes tensors on one device and computes there: the tensors' device, not
a switch, decides whether the streaming solver runs the CUDA kernels
(``ops/cuda/gram.py``, ``ops/cuda/sweep.py``; ``ops/cuda/pass3.py`` for float32 rows) or
their plain PyTorch versions.

Every public function runs its float32 products in IEEE float32 (``utils/precision.py``),
as the JAX functions' ``precision=HIGHEST`` default, whatever the caller set for its own
cuBLAS work. ``sweep_precision="fast"`` (JAX's ``sweep_precision=DEFAULT``) runs the
γ-sweep's products only in one TF32 pass: in memory the two contractions, streaming K2's
one-pass path.
"""

from collections.abc import Callable
from typing import Any, Literal, NamedTuple

import numpy as np
import torch

from neo_ls_svm_torch.ops.cuda._build import PATH_TF32
from neo_ls_svm_torch.ops.cuda.gram import fused_augmented_gram, gram_plain, w_basis_from_augmented
from neo_ls_svm_torch.ops.cuda.pass3 import fused_pass3, pass3_plain
from neo_ls_svm_torch.ops.cuda.sweep import fused_loo_sweep
from neo_ls_svm_torch.utils.precision import SWEEP_MATMUL, check_sweep_precision, matmul_precision
from neo_ls_svm_torch.utils.profiling import span

# Result keys with one entry per input row (everything else is grid- or basis-sized).
PER_ROW_KEYS = frozenset({"loo_residuals", "loo_yhat", "loo_leverage", "loo_std", "residuals"})


def _primal_working_set_bytes(n_rows: int, num_features: int, itemsize: int) -> int:
    """Primal-solver working-set estimate: ~3 transient copies of the n×2M real
    embedding of φ. The estimator's route decision thresholds on it."""
    return 3 * n_rows * 2 * (num_features + 1) * itemsize


def trim_per_row(result: dict, num_samples: int) -> dict:
    """Drop padding rows from the per-row outputs of a (padded) solver result."""
    return {k: (v[:num_samples] if k in PER_ROW_KEYS else v) for k, v in result.items()}


def gamma_grid(dtype: Any, num: int = 1024, lo: float = 1e-6, hi: float = 20.0) -> np.ndarray:
    """The γ grid the LOO sweep evaluates (ref ``_neo_ls_svm.py:146,270``)."""
    return np.logspace(np.log10(lo), np.log10(hi), num, dtype=dtype)


def _features_real_pair(X: torch.Tensor, M_map: torch.Tensor, b_map: torch.Tensor) -> torch.Tensor:
    """Build W = [cos U/√D, 1 | sin U/√D, 0] from the folded affine map U = X@M + b.

    The two M-column halves are the real part P and minus-the-imaginary part (−N) of
    φ = exp(-1j·U)/√D with its bias column: P = [cos U/√D, 1], N = [−sin U/√D, 0].
    """
    n = X.shape[0]
    D = M_map.shape[1]
    U = X @ M_map + b_map
    inv_sqrt_D = 1.0 / torch.sqrt(torch.tensor(D, dtype=X.dtype, device=X.device))
    ones = torch.ones((n, 1), dtype=X.dtype, device=X.device)
    zeros = torch.zeros((n, 1), dtype=X.dtype, device=X.device)
    return torch.cat([torch.cos(U) * inv_sqrt_D, ones, torch.sin(U) * inv_sqrt_D, zeros], dim=1)


def embed_from_gram_blocks(G: torch.Tensor, M: int) -> torch.Tensor:
    """Recombine the blocks of a WᵀS²W Gram into the symmetrised real embedding.

    φ = P - i·N  ⇒  A = φᴴS²φ has  Re A = PᵀS²P + NᵀS²N,  Im A = PᵀS²N - NᵀS²P,
    and E(A) = [[Re A, -Im A], [Im A, Re A]].
    """
    PP, PN = G[:M, :M], G[:M, M:]
    NP, NN = G[M:, :M], G[M:, M:]
    Ar = PP + NN
    Ai = PN - NP
    B = torch.cat([torch.cat([Ar, -Ai], dim=1), torch.cat([Ai, Ar], dim=1)], dim=0)
    return (B + B.T) / 2


# Rows of W in each float64 product of the in-memory Gram (:func:`_embedding_gram`).
GRAM_ROW_BLOCK = 32768


def _embedding_gram(W: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """E(φᴴS²φ): the blocks of WᵀS²W, recombined into the real embedding, in W's dtype.

    WᵀS²W is summed in float64, one product per ``GRAM_ROW_BLOCK`` rows. A float32 product
    sums each entry over every row in turn, and terms as alike as the bias column's s²
    (1/n² on every row of an unweighted fit) lose a share of the sum that grows with n:
    4e-4 over 463,715 rows, a Gram farther from float64 than one formed in TF32, which
    the LOO re-solve then multiplies by its condition number. The streaming solver's K1
    bounds its float32 accumulation runs instead (``ops/cuda/csrc/gram.cu``).
    """
    M2 = W.shape[1]
    G = torch.zeros((M2, M2), dtype=torch.float64, device=W.device)
    for start in range(0, W.shape[0], GRAM_ROW_BLOCK):
        rows = slice(start, start + GRAM_ROW_BLOCK)
        W_b = W[rows].double()
        G += (W_b.T * s2[None, rows].double()) @ W_b
    return embed_from_gram_blocks(G, M2 // 2).to(W.dtype)


def _inv_c0_scale(n: "torch.Tensor | int", M: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """1/c₀ = n·M, computed in floating point.

    Cast to the float dtype BEFORE the multiply: as integers n·M would wrap int32 once it
    exceeds 2³¹ (n ≈ 4.2M rows at M = 513).
    """
    if isinstance(n, torch.Tensor):
        return n.to(dtype) * torch.tensor(M, dtype=dtype, device=n.device)
    return torch.tensor(float(n) * M, dtype=dtype, device=device)


def _clip_classifier_residuals(e: torch.Tensor, y: torch.Tensor, is_classifier: bool) -> torch.Tensor:
    """Zero the residuals of confidently-correct classifications (ref ``:153-155``)."""
    if not is_classifier:
        return e
    y_b = y if e.ndim == 1 else y[:, None]
    return torch.where(((y_b > 0) & (e > 0)) | ((y_b < 0) & (e < 0)), torch.zeros_like(e), e)


def _sweep_objective(
    e: torch.Tensor, s: torch.Tensor, is_classifier: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-abs-LOO error and the γ-selection objective (ref ``:158-165``)."""
    abs_e = torch.abs(e)
    loo_err = s @ abs_e
    if is_classifier:
        objective = s @ (abs_e >= 1).to(e.dtype) + s @ torch.clamp(abs_e - 1, min=0.0) + loo_err
    else:
        objective = loo_err
    return loo_err, objective


def _eigendecompose(
    B: torch.Tensor, C_emb: torch.Tensor | None, inv_c0: torch.Tensor, sign: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigendecompose the embedded Gram against the complexity matrix.

    Returns (λ, Qs, scale) with Qs = J@Q sign-folded so Z@Q = W@Qs, and ``scale`` the
    factor in (γC + A)⁻¹ = scale · Q diag(1/(γ+λ)) Qᵀ (1 for the GEVD path).
    """
    if C_emb is None:
        lam, Q = torch.linalg.eigh(inv_c0 * B)
    else:
        # Whitened GEVD: A·Q = C·Q·Λ with Q = Lc⁻ᵀ·Q́, eigh(Lc⁻¹·A·Lc⁻ᵀ) = Q́ΛQ́ᵀ.
        # Q is C-orthonormal, so (γC + A)⁻¹ = Q (γI + Λ)⁻¹ Qᵀ with no extra scaling.
        Lc = torch.linalg.cholesky(C_emb)
        half = torch.linalg.solve_triangular(Lc, B, upper=False)
        Bw = torch.linalg.solve_triangular(Lc, half.T, upper=False).T
        Bw = (Bw + Bw.T) / 2
        lam, Qw = torch.linalg.eigh(Bw)
        Q = torch.linalg.solve_triangular(Lc.T, Qw, upper=True)
        inv_c0 = torch.ones((), dtype=B.dtype, device=B.device)
    # Z = [P, -N] = W @ blockdiag(I, -I); fold the sign flip into Q once.
    return lam, sign[:, None] * Q, inv_c0


def _sign_vector(M: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    return torch.cat(
        [torch.ones(M, dtype=dtype, device=device), -torch.ones(M, dtype=dtype, device=device)]
    )


def _regularised_gram(
    B: torch.Tensor, C_emb: torch.Tensor | None, gamma_opt: torch.Tensor, inv_c0_id: torch.Tensor
) -> torch.Tensor:
    """γC + A in the embedding, for the Cholesky re-solve at the optimum (ref :177-178)."""
    if C_emb is None:
        eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
        return B + (gamma_opt / inv_c0_id) * eye
    return B + gamma_opt * C_emb


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _loo_score(
    y: torch.Tensor,
    s: torch.Tensor,
    e_raw: torch.Tensor,
    is_classifier: bool,
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> torch.Tensor:
    """LOO accuracy (classifier) or LOO R² (regressor) from pre-clip residuals.

    ``row_sum`` completes each weighted moment over rows held elsewhere (see
    :func:`primal_fit`); padding rows carry s = 0 and move no moment.
    """
    if is_classifier:
        return row_sum(s @ (torch.sign(y + e_raw) == y).to(y.dtype))
    y_mean = row_sum(s @ y)
    return 1.0 - row_sum(s @ (e_raw * e_raw)) / row_sum(s @ ((y - y_mean) * (y - y_mean)))


class _Swept(NamedTuple):
    """What the in-memory γ-sweep leaves: its answer, the LOO error and the γ-selection
    objective of every γ, each summed over all rows, and the per-row products Gu∘Gu and
    Gu∘k that the optimum's statistics reuse."""

    loo_errors: torch.Tensor
    objective: torch.Tensor
    Gu2: torch.Tensor
    Gu_k: torch.Tensor


def _sweep_in_memory(
    W: torch.Tensor,
    Qs: torch.Tensor,
    k: torch.Tensor,
    lam: torch.Tensor,
    y: torch.Tensor,
    s: torch.Tensor,
    s2: torch.Tensor,
    gammas: torch.Tensor,
    inv_c0: torch.Tensor,
    *,
    is_classifier: bool,
    gamma_chunk: int,
    sweep_precision: Literal["high", "fast"],
    row_sum: Callable[[torch.Tensor], torch.Tensor],
) -> _Swept:
    """The LOO error and the γ-selection objective of every γ on the grid, from the feature
    matrix W held whole: Gu = W·Qs, then per chunk of γ the resolvent columns
    r = 1/(γ + λ) and the two contractions (Gu∘k)·r and (Gu∘Gu)·r, the residuals, their
    clip and their weighted sums (:func:`primal_fit`)."""
    Gu = W @ Qs  # n×2M: rows are zᵢᵀQ.
    Gu2 = Gu * Gu
    Gu_k = Gu * k[None, :]
    s2_col = s2[:, None]

    loo_err_parts, obj_parts = [], []
    for start in range(0, gammas.shape[0], gamma_chunk):
        r = 1.0 / (gammas[None, start : start + gamma_chunk] + lam[:, None])  # 2M × chunk
        with matmul_precision(SWEEP_MATMUL[sweep_precision]):
            num = inv_c0 * (Gu_k @ r)
            lev = inv_c0 * s2_col * (Gu2 @ r)
        e = (num - y[:, None]) / (1.0 - lev)
        e = _clip_classifier_residuals(e, y, is_classifier)
        loo_err_c, obj_c = _sweep_objective(e, s, is_classifier)
        loo_err_parts.append(loo_err_c)
        obj_parts.append(obj_c)
    loo_errors_gs, objective = row_sum(torch.stack([torch.cat(loo_err_parts), torch.cat(obj_parts)]))
    return _Swept(loo_errors_gs, objective, Gu2, Gu_k)


def _optimum_in_memory(
    W: torch.Tensor,
    B: torch.Tensor,
    C_emb: torch.Tensor | None,
    swept: _Swept,
    y: torch.Tensor,
    s: torch.Tensor,
    s2: torch.Tensor,
    gammas: torch.Tensor,
    lam: torch.Tensor,
    Qs: torch.Tensor,
    b_vec: torch.Tensor,
    sign: torch.Tensor,
    inv_c0: torch.Tensor,
    inv_c0_id: torch.Tensor,
    *,
    is_classifier: bool,
    row_sum: Callable[[torch.Tensor], torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The γ at the objective's first minimum, its per-row LOO statistics from the sweep's
    products, the Cholesky re-solve of β̂ there and the training residuals: the result of
    :func:`primal_fit`."""
    optimum = torch.argmin(swept.objective)  # the FIRST minimum, as jnp.argmin
    gamma_opt = gammas[optimum]

    # Recompute the optimum's full LOO vectors (cheap: one resolvent column).
    r_opt = 1.0 / (gamma_opt + lam)
    sigma2 = inv_c0 * (swept.Gu2 @ r_opt)
    phi_beta_opt = inv_c0 * (swept.Gu_k @ r_opt)
    lev_opt = s2 * sigma2
    e_raw = (phi_beta_opt - y) / (1.0 - lev_opt)
    e_clipped = _clip_classifier_residuals(e_raw, y, is_classifier)
    loo_score = _loo_score(y, s, e_raw, is_classifier, row_sum)

    # Re-solve (γC + A)β̂ = φᴴS²y at the optimum via Cholesky for accuracy (ref :177-178),
    # in embedding space: (γ·C + B) β̂_emb = Zᵀ S² y.
    L = torch.linalg.cholesky(_regularised_gram(B, C_emb, gamma_opt, inv_c0_id))
    beta_emb = torch.cholesky_solve((sign * b_vec)[:, None], L)[:, 0]
    # Z @ β̂_emb = W @ (J β̂_emb).
    residuals = _clip_classifier_residuals(W @ (sign * beta_emb) - y, y, is_classifier)

    # Bayesian LOO predictive variance via the eigenbasis plus the Sherman–Morrison
    # leave-one-out correction (ref :183-187).
    loo_sigma2 = sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)

    return {
        "beta_emb": beta_emb,
        "gamma": gamma_opt,
        "optimum_index": optimum,
        "lam": lam,
        "Qs": Qs,
        "loo_errors_gammas": swept.loo_errors,
        "loo_residuals": e_clipped,
        "loo_yhat": y + e_clipped,
        "loo_leverage": lev_opt,
        "loo_error": swept.loo_errors[optimum],
        "loo_score": loo_score,
        "loo_std": torch.sqrt(loo_sigma2),
        "residuals": residuals,
    }


@matmul_precision("ieee")
def primal_fit(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    gammas: torch.Tensor,
    C_emb: torch.Tensor | None = None,
    *,
    is_classifier: bool,
    gamma_chunk: int = 128,
    num_samples: int | None = None,
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    sweep_precision: Literal["high", "fast"] = "high",
    working_set_bytes: int | None = None,
) -> dict[str, torch.Tensor]:
    """Fit the primal LS-SVM in memory and tune γ by closed-form leave-one-out error.

    Returns the fitted coefficients (in embedding space), the eigenbasis needed for
    out-of-sample predictive variance, and every LOO statistic the estimator exposes
    (ref attribute list ``_neo_ls_svm.py:146-187``).

    ``num_samples`` overrides the row count used in the c₀ normalisation so callers may
    pad X with zero-weight rows without perturbing the solution. ``C_emb`` is the
    *normalised* complexity matrix in the real embedding (2M×2M); None is the shipped
    scaled identity.

    ``row_sum`` is applied to every sum over rows (the weight total, the Gram, WᵀS²y,
    the sweep's sums and the LOO score's moments): the identity here, and a sum across
    ranks when X holds one rank's rows (``parallel/mesh.py::sharded_primal_fit``). The
    per-row outputs are then this rank's rows.

    ``sweep_precision`` controls only the γ-sweep's two contractions, (Gu∘k)·r and
    (Gu∘Gu)·r: "fast" runs them in one TF32 pass on a CUDA device, as JAX runs them at
    ``sweep_precision``. Gu, WᵀS²y, the optimum's statistics and the Cholesky re-solve
    stay IEEE float32, and the Gram is summed in float64 (:func:`_embedding_gram`).

    ``working_set_bytes`` is the fit plan's estimate that chose this route, recorded on the
    ``neo.solve`` span; None records the estimate for the rows X holds (on a mesh, this
    rank's: the share the estimator holds to the threshold).

    Its spans (README, "Profiling a fit"): ``neo.solve`` (``route="inmemory"``) around
    ``neo.solve.gram`` (W and the embedded Gram), ``neo.solve.eigh`` (the eigenbasis,
    WᵀS²y and k), ``neo.solve.sweep`` (:func:`_sweep_in_memory`) and
    ``neo.solve.optimum`` (:func:`_optimum_in_memory`).
    """
    n = X.shape[0] if num_samples is None else num_samples
    dtype, device = X.dtype, X.device
    if working_set_bytes is None:
        working_set_bytes = _primal_working_set_bytes(X.shape[0], M_map.shape[1], X.element_size())
    with span("neo.solve", device=device, route="inmemory", working_set_bytes=working_set_bytes):
        check_sweep_precision(sweep_precision)
        s = sample_weight / row_sum(torch.sum(sample_weight))
        s2 = s * s
        with span("neo.solve.gram", device=device):
            W = _features_real_pair(X, M_map, b_map)
            B = row_sum(_embedding_gram(W, s2))
        M2 = W.shape[1]
        M = M2 // 2
        # c₀: the normalised complexity matrix is c₀·I with c₀ = 1/(n·M) (ref :117-118 with
        # the shipped identity complexity matrix; φ.size = n·M).
        inv_c0 = _inv_c0_scale(n, M, dtype, device)
        inv_c0_id = inv_c0  # Identity-C resolvent scale, kept for the re-solve below.
        sign = _sign_vector(M, dtype, device)
        with span("neo.solve.eigh", device=device):
            lam, Qs, inv_c0 = _eigendecompose(B, C_emb, inv_c0, sign)
            b_vec = row_sum(W.T @ (s2 * y))  # Wᵀ S² y
            k = Qs.T @ b_vec  # QᵀZᵀS²y
        chunks = -(-gammas.shape[0] // gamma_chunk)
        with span("neo.solve.sweep", device=device, gamma_chunks=chunks):
            swept = _sweep_in_memory(
                W, Qs, k, lam, y, s, s2, gammas, inv_c0,
                is_classifier=is_classifier, gamma_chunk=gamma_chunk, sweep_precision=sweep_precision,
                row_sum=row_sum,
            )
        with span("neo.solve.optimum", device=device):
            result = _optimum_in_memory(
                W, B, C_emb, swept, y, s, s2, gammas, lam, Qs, b_vec, sign, inv_c0, inv_c0_id,
                is_classifier=is_classifier, row_sum=row_sum,
            )
    return result


@matmul_precision("ieee")
def primal_decision_function(
    X: torch.Tensor, M_map: torch.Tensor, b_map: torch.Tensor, beta_emb: torch.Tensor
) -> torch.Tensor:
    """ŷ(x) = Re(φ(x)ᵀβ̂) (ref ``:661-665``)."""
    W = _features_real_pair(X, M_map, b_map)
    sign = _sign_vector(W.shape[1] // 2, X.dtype, X.device)
    return W @ (sign * beta_emb)


def _variance_from_features(
    W: torch.Tensor, Qs: torch.Tensor, lam: torch.Tensor, gamma: Any, inv_c0: Any
) -> torch.Tensor:
    Gu = W @ Qs
    return inv_c0 * ((Gu * Gu) @ (1.0 / (gamma + lam)))


@matmul_precision("ieee")
def primal_decision_var(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    beta_emb: torch.Tensor,
    Qs: torch.Tensor,
    lam: torch.Tensor,
    gamma: Any,
    inv_c0: Any,
) -> torch.Tensor:
    """ŷ(x) and σ²(x) stacked (n, 2), sharing one feature build."""
    W = _features_real_pair(X, M_map, b_map)
    sign = _sign_vector(W.shape[1] // 2, X.dtype, X.device)
    yhat = W @ (sign * beta_emb)
    return torch.stack([yhat, _variance_from_features(W, Qs, lam, gamma, inv_c0)], dim=1)


@matmul_precision("ieee")
def primal_predict_var(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    Qs: torch.Tensor,
    lam: torch.Tensor,
    gamma: Any,
    inv_c0: Any,
) -> torch.Tensor:
    """σ²(x) = Re(φ(x)ᵀ(γC + A)⁻¹φ(x)) via the stored eigenbasis (ref ``:464-469``)."""
    return _variance_from_features(_features_real_pair(X, M_map, b_map), Qs, lam, gamma, inv_c0)


@matmul_precision("ieee")
def primal_fit_streaming(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    gammas: torch.Tensor,
    C_emb: torch.Tensor | None = None,
    *,
    is_classifier: bool,
    row_chunk: int = 16384,
    num_samples: int | None = None,
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    sweep_precision: Literal["high", "fast"] = "high",
    working_set_bytes: int | None = None,
) -> dict[str, torch.Tensor]:
    """Streaming variant of :func:`primal_fit`: O(row_chunk·2M) device memory.

    Three passes over the rows — (1) the augmented Gram, (2) the γ-sweep objective,
    (3) per-row statistics at the optimum — rebuild the cos/sin feature block instead
    of materialising the n×2M feature matrix. Passes 1 and 2 are the fused kernels K1
    (``fused_augmented_gram``, only with the identity complexity matrix, as the JAX
    package routes it) and K2 (``fused_loo_sweep``); on CPU tensors both run their plain
    PyTorch versions. Pass 3 is K3 (``fused_pass3``) for float32 rows on a CUDA device and
    ``pass3_plain`` otherwise; its span ``neo.solve.pass3`` says which (``path``). Callers
    pad rows to a multiple of ``row_chunk`` with zero sample weights and pass the true row
    count via ``num_samples``.

    ``row_sum`` is :func:`primal_fit`'s hook, applied to the weight total, the augmented
    Gram, the γ-sweep's sums and the LOO score's moments
    (``parallel/mesh.py::sharded_primal_fit_streaming``). ``sweep_precision`` is K2's
    ``precision`` (its one-pass TF32 path under "fast"); passes 1 and 3 stay IEEE.
    ``working_set_bytes`` is :func:`primal_fit`'s.
    """
    n_pad = X.shape[0]
    n = n_pad if num_samples is None else num_samples
    dtype, device = X.dtype, X.device
    if working_set_bytes is None:
        working_set_bytes = _primal_working_set_bytes(n_pad, M_map.shape[1], X.element_size())
    with span("neo.solve", device=device, route="streaming", working_set_bytes=working_set_bytes):
        check_sweep_precision(sweep_precision)
        if n_pad % row_chunk:
            msg = f"pad rows to a multiple of row_chunk={row_chunk}, got {n_pad} rows"
            raise ValueError(msg)
        D = M_map.shape[1]
        M = D + 1
        M2 = 2 * M
        s = sample_weight / row_sum(torch.sum(sample_weight))
        s2 = s * s
        sign = _sign_vector(M, dtype, device)

        # Pass 1: one augmented Gram holds every second-order statistic at once —
        # Y = [cos | sin | 1 | y] so YᵀS²Y contains the Gram, the rhs WᵀS²y, and yᵀS²y.
        with span("neo.solve.k1", device=device):
            if C_emb is None:
                G_aug = fused_augmented_gram(X, M_map, b_map, s2, y)
            else:
                G_aug = gram_plain(X, M_map, b_map, s2, y, chunk_rows=row_chunk)
            G, b_vec = w_basis_from_augmented(row_sum(G_aug), D)
        B = embed_from_gram_blocks(G, M)

        inv_c0 = _inv_c0_scale(n, M, dtype, device)
        inv_c0_id = inv_c0  # Identity-C resolvent scale, kept for the re-solve below.
        inv_c0_kernels = float(n) * M if C_emb is None else 1.0  # inv_c0's value, for K2 and K3
        with span("neo.solve.eigh", device=device):
            lam, Qs, inv_c0 = _eigendecompose(B, C_emb, inv_c0, sign)
            k = Qs.T @ b_vec

        # Pass 2: γ-sweep objective reduction over all rows.
        with span("neo.solve.k2", device=device):
            r_all = (1.0 / (gammas[None, :] + lam[:, None])).contiguous()  # 2M × G
            loo_errors_gs, objective = row_sum(torch.stack(fused_loo_sweep(
                X,
                M_map,
                b_map,
                y,
                s,
                s2,
                Qs.contiguous(),
                r_all,
                k,
                is_classifier=is_classifier,
                inv_c0=inv_c0_kernels,
                precision=sweep_precision,
            )))
            optimum = torch.argmin(objective)  # the FIRST minimum, as jnp.argmin
            gamma_opt = gammas[optimum]

        # Cholesky re-solve at the optimum (ref :177-178).
        L = torch.linalg.cholesky(_regularised_gram(B, C_emb, gamma_opt, inv_c0_id))
        beta_emb = torch.cholesky_solve((sign * b_vec)[:, None], L)[:, 0]

        # Pass 3: per-row LOO statistics and residuals at the optimum, K3 for float32 rows on
        # a CUDA device (as the JAX package's HIGHEST: 3×TF32 under either sweep_precision).
        on_kernel = device.type == "cuda" and dtype == torch.float32
        with span("neo.solve.pass3", device=device, path=PATH_TF32 if on_kernel else "plain"):
            r_opt = 1.0 / (gamma_opt + lam)
            kr_opt = k * r_opt
            beta_j = sign * beta_emb
            if on_kernel:
                num, sigma2, resid = fused_pass3(
                    X, M_map, b_map, y, Qs.contiguous(), kr_opt, r_opt, beta_j, inv_c0=inv_c0_kernels
                )
            else:
                num, sigma2, resid = pass3_plain(
                    X, M_map, b_map, y, Qs, kr_opt, r_opt, beta_j, inv_c0=inv_c0, chunk_rows=row_chunk
                )
            lev_opt = s2 * sigma2
            e_raw = (num - y) / (1.0 - lev_opt)
            residuals = _clip_classifier_residuals(resid, y, is_classifier)
            e_clipped = _clip_classifier_residuals(e_raw, y, is_classifier)
            loo_score = _loo_score(y, s, e_raw, is_classifier, row_sum)
            loo_sigma2 = sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)

        return {
            "beta_emb": beta_emb,
            "gamma": gamma_opt,
            "optimum_index": optimum,
            "lam": lam,
            "Qs": Qs,
            "loo_errors_gammas": loo_errors_gs,
            "loo_residuals": e_clipped,
            "loo_yhat": y + e_clipped,
            "loo_leverage": lev_opt,
            "loo_error": loo_errors_gs[optimum],
            "loo_score": loo_score,
            "loo_std": torch.sqrt(loo_sigma2),
            "residuals": residuals,
        }
