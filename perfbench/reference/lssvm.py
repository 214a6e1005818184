"""The plain reference of a streaming LS-SVM fit, from the feature map's operands on.

A restatement in plain PyTorch of the algorithm that ``NeoLSSVM`` runs on the primal route
(the reference package's ``_optimize_β̂_γ``): random Fourier features of the folded affine
map U = X·M + b, the augmented Gram G = Yᵀ·diag(s²)·Y of Y = [cos U/√D | sin U/√D | 1 | y],
its exact real symmetric embedding and one eigendecomposition, the closed-form leave-one-out
(LOO) residuals of every γ on the grid and the γ-selection objective, the Cholesky re-solve
at a γ, and the per-row statistics there. It imports nothing of the program. The sweep is
worked out from the operands it is handed (an eigenbasis, its resolvent columns and the
projected target), so that it can be held on the very operands that the program's sweep
got; :meth:`Fit.operands` makes them from the fit's own eigendecomposition.

``mode`` names the arithmetic: ``"f64"`` is the reference; ``"f32"`` (IEEE float32) and
``"tf32"`` (float32 with every product on the TF32 tensor cores) are the lower precisions
that a control puts in the program's place. Rows are processed in blocks, so that the
reference fits beside nothing else on the device.
"""

import contextlib
from collections.abc import Iterator

import numpy as np
import torch

MODES = ("f64", "f32", "tf32")


@contextlib.contextmanager
def arithmetic(mode: str) -> Iterator[torch.dtype]:
    """The compute dtype of ``mode``, with the float32 products' precision set for it and
    the caller's setting restored afterwards."""
    if mode not in MODES:
        msg = f"mode must be one of {MODES}, got {mode!r}"
        raise ValueError(msg)
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "tf32" if mode == "tf32" else "ieee"
    try:
        yield torch.float64 if mode == "f64" else torch.float32
    finally:
        matmul.fp32_precision = saved


def gamma_grid(dtype: np.dtype, num: int = 1024, lo: float = 1e-6, hi: float = 20.0) -> np.ndarray:
    """The γ grid of the fit: ``num`` log-spaced values from ``lo`` to ``hi`` in the rows'
    dtype (the reference package's ``_neo_ls_svm.py:146``)."""
    return np.logspace(np.log10(lo), np.log10(hi), num, dtype=dtype)


def signed_target(y: np.ndarray, is_classifier: bool, dtype: np.dtype) -> np.ndarray:
    """The target the solver fits: ±1 for a classifier (+1 for the larger label), else y."""
    if is_classifier:
        return np.where(y == np.max(y), 1.0, -1.0).astype(dtype)
    return y.astype(dtype)


def _blocks(n: int, block: int) -> Iterator[slice]:
    for start in range(0, n, block):
        yield slice(start, min(start + block, n))


def _phases(X_host: np.ndarray, rows: slice, M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    X_b = torch.from_numpy(np.ascontiguousarray(X_host[rows])).to(M.device, M.dtype)
    return X_b @ M + b.reshape(1, -1)


def _w_rows(U: torch.Tensor) -> torch.Tensor:
    """W = [cos U/√D, 1 | sin U/√D, 0]: the real and minus-imaginary parts of
    φ = exp(-iU)/√D, each with its bias column."""
    D = U.shape[1]
    ones = torch.ones((U.shape[0], 1), dtype=U.dtype, device=U.device)
    return torch.cat([torch.cos(U) / D**0.5, ones, torch.sin(U) / D**0.5, 0 * ones], dim=1)


def augmented_gram(
    X_host: np.ndarray, y: torch.Tensor, s2: torch.Tensor, M: torch.Tensor, b: torch.Tensor, block: int
) -> torch.Tensor:
    """G = Yᵀ·diag(s²)·Y, Y = [cos U/√D | sin U/√D | 1 | y], summed over blocks of rows."""
    D = M.shape[1]
    K = 2 * D + 2
    G = torch.zeros((K, K), dtype=M.dtype, device=M.device)
    for rows in _blocks(len(X_host), block):
        U = _phases(X_host, rows, M, b)
        ones = torch.ones((U.shape[0], 1), dtype=U.dtype, device=U.device)
        Y = torch.cat([torch.cos(U) / D**0.5, torch.sin(U) / D**0.5, ones, y[rows, None]], dim=1)
        G += (Y.T * s2[None, rows]) @ Y
    return G


def _w_basis(G_aug: torch.Tensor, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(WᵀS²W, WᵀS²y) from the augmented Gram: W's columns are [cos, 1, sin, 0]."""
    M2 = 2 * (D + 1)
    idx = torch.cat([torch.arange(D), torch.tensor([2 * D]), torch.arange(D, 2 * D)]).to(G_aug.device)
    G_W = torch.zeros((M2, M2), dtype=G_aug.dtype, device=G_aug.device)
    G_W[: M2 - 1, : M2 - 1] = G_aug[idx[:, None], idx[None, :]]
    b_vec = torch.zeros(M2, dtype=G_aug.dtype, device=G_aug.device)
    b_vec[: M2 - 1] = G_aug[idx, 2 * D + 1]
    return G_W, b_vec


def _embedding(G_W: torch.Tensor) -> torch.Tensor:
    """E(A) = [[Re A, -Im A], [Im A, Re A]] of A = φᴴS²φ, φ = P - iN, from the blocks of
    G_W: Re A = PᵀS²P + NᵀS²N, Im A = PᵀS²N - NᵀS²P."""
    M = G_W.shape[0] // 2
    Ar = G_W[:M, :M] + G_W[M:, M:]
    Ai = G_W[:M, M:] - G_W[M:, :M]
    B = torch.cat([torch.cat([Ar, -Ai], dim=1), torch.cat([Ai, Ar], dim=1)], dim=0)
    return (B + B.T) / 2


def _clip(e: torch.Tensor, y: torch.Tensor, is_classifier: bool) -> torch.Tensor:
    """A classifier's confidently correct residuals count as 0."""
    if not is_classifier:
        return e
    y_b = y if e.ndim == 1 else y[:, None]
    return torch.where(((y_b > 0) & (e > 0)) | ((y_b < 0) & (e < 0)), torch.zeros_like(e), e)


class Fit:
    """The reference fit of rows ``X_host`` (NumPy) and target ``y_signed`` with unit
    weights on the operands ``M`` (d×D) and ``b`` (D,), in ``mode``'s arithmetic on
    ``device``. ``gram`` is the augmented Gram and ``B`` its real embedding;
    :meth:`operands` gives the γ-sweep's operands from its own eigendecomposition,
    :meth:`sweep` the γ-selection objective and the per-row statistics from any such
    operands, and :meth:`beta` the solution at any grid index."""

    def __init__(
        self,
        X_host: np.ndarray,
        y_signed: np.ndarray,
        M: np.ndarray,
        b: np.ndarray,
        gammas: np.ndarray,
        *,
        is_classifier: bool,
        mode: str,
        device: torch.device,
        block: int = 65536,
    ) -> None:
        self.X_host, self.is_classifier, self.mode, self.block = X_host, is_classifier, mode, block
        with arithmetic(mode) as dtype:
            self.dtype = dtype
            n = len(X_host)
            self.n = n
            to = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
            self.M, self.b = to(M), to(b).reshape(-1)
            self.y = to(y_signed)
            self.s = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
            self.s2 = self.s * self.s
            self.gammas = to(gammas)
            D = self.M.shape[1]
            Mf = D + 1
            self.gram = augmented_gram(X_host, self.y, self.s2, self.M, self.b, block)
            G_W, self.b_vec = _w_basis(self.gram, D)
            self.B = _embedding(G_W)
            self.inv_c0 = float(n) * Mf
            self.sign = torch.cat([torch.ones(Mf, dtype=dtype, device=device), -torch.ones(Mf, dtype=dtype, device=device)])

    def operands(self) -> dict[str, torch.Tensor]:
        """The γ-sweep's operands from this fit's own eigendecomposition of c₀⁻¹·B: the
        sign-folded eigenbasis Qs, the resolvent columns r_all = 1/(γ + λ) and k = Qsᵀ·WᵀS²y."""
        with arithmetic(self.mode):
            lam, Q = torch.linalg.eigh(self.inv_c0 * self.B)
            Qs = self.sign[:, None] * Q
            return {"Qs": Qs, "r_all": 1.0 / (self.gammas[None, :] + lam[:, None]), "k": Qs.T @ self.b_vec}

    def sweep(self, operands: dict, index: int | None = None) -> dict[str, np.ndarray]:
        """The LOO error and the γ-selection objective over the grid from ``operands`` (Qs,
        r_all, k, as the sweep gets them), and with ``index`` the LOO predictions y + e at that grid index
        and the training residuals W·Jβ − y of this fit's β there (a classifier's
        confidently correct ones as 0); all as NumPy float64."""
        with arithmetic(self.mode):
            device = self.M.device
            Qs, r_all, k = (torch.as_tensor(operands[name], device=device).to(self.dtype) for name in ("Qs", "r_all", "k"))
            loo_error = torch.zeros(r_all.shape[1], dtype=self.dtype, device=device)
            objective = torch.zeros_like(loo_error)
            beta_j = None if index is None else self.sign * self._beta(index)
            loo_yhat, resid = [], []
            for rows in _blocks(self.n, self.block):
                W = _w_rows(_phases(self.X_host, rows, self.M, self.b))
                Gu = W @ Qs
                num = self.inv_c0 * ((Gu * k[None, :]) @ r_all)
                lev = self.inv_c0 * self.s2[rows, None] * ((Gu * Gu) @ r_all)
                del Gu
                y_b = self.y[rows]
                e = _clip((num - y_b[:, None]) / (1.0 - lev), y_b, self.is_classifier)
                del num, lev
                abs_e = e.abs()
                s_b = self.s[rows]
                err_b = s_b @ abs_e
                loo_error += err_b
                objective += err_b
                if self.is_classifier:
                    objective += s_b @ (abs_e >= 1).to(self.dtype) + s_b @ torch.clamp(abs_e - 1, min=0.0)
                if beta_j is not None:
                    loo_yhat.append((y_b + e[:, index]).double().cpu())
                    resid.append(_clip(W @ beta_j - y_b, y_b, self.is_classifier).double().cpu())
                del e, abs_e
            out = {"loo_error": loo_error.double().cpu().numpy(), "objective": objective.double().cpu().numpy()}
            if beta_j is not None:
                out |= {"loo_yhat": torch.cat(loo_yhat).numpy(), "residuals": torch.cat(resid).numpy()}
            return out

    def beta(self, index: int) -> np.ndarray:
        """β in the embedding at the grid's ``index``-th γ, by the Cholesky re-solve of
        (B + γ/c₀⁻¹·I)β = J·WᵀS²y, as NumPy float64."""
        with arithmetic(self.mode):
            return self._beta(index).double().cpu().numpy()

    def _beta(self, index: int) -> torch.Tensor:
        eye = torch.eye(self.B.shape[0], dtype=self.dtype, device=self.B.device)
        L = torch.linalg.cholesky(self.B + (self.gammas[index] / self.inv_c0) * eye)
        return torch.cholesky_solve((self.sign * self.b_vec)[:, None], L)[:, 0]
