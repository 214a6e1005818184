"""The leave-one-out math that the primal solvers and the kernels' plain versions share.

The random-Fourier feature block of a row chunk, the classifier's residual clip and the
γ-selection objective (ref ``_neo_ls_svm.py:153-165``). ``models/primal.py``,
``models/dual.py``, ``parallel/mesh.py`` and the plain versions of K1, K2 and K3
(``ops/cuda/gram.py``, ``sweep.py``, ``pass3.py``) take them from here, so that each
formula is written once.
"""

import torch


def identity(t: torch.Tensor) -> torch.Tensor:
    """The default of the solvers' ``row_sum`` and ``feature_sum`` hooks: nothing held
    elsewhere to add."""
    return t


def inv_sqrt_width(X: torch.Tensor, M_map: torch.Tensor) -> torch.Tensor:
    """1/√D, D = M_map's width, as a 0-dim tensor in X's dtype on X's device, filled there
    (no host copy, so no wait for the stream); a row-chunk loop makes it once."""
    return 1.0 / torch.sqrt(torch.full((), M_map.shape[1], dtype=X.dtype, device=X.device))


def fourier_pair(
    X: torch.Tensor, M_map: torch.Tensor, b_map: torch.Tensor, inv_sqrt_D: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos U/√D and sin U/√D of the folded affine map U = X·M + b; ``inv_sqrt_D`` is
    :func:`inv_sqrt_width`'s, made here if None."""
    if inv_sqrt_D is None:
        inv_sqrt_D = inv_sqrt_width(X, M_map)
    U = X @ M_map + b_map.reshape(1, -1)
    return torch.cos(U) * inv_sqrt_D, torch.sin(U) * inv_sqrt_D


def features_real_pair(
    X: torch.Tensor, M_map: torch.Tensor, b_map: torch.Tensor, inv_sqrt_D: torch.Tensor | None = None
) -> torch.Tensor:
    """Build W = [cos U/√D, 1 | sin U/√D, 0] from the folded affine map U = X@M + b.

    The two M-column halves are the real part P and minus-the-imaginary part (−N) of
    φ = exp(-1j·U)/√D with its bias column: P = [cos U/√D, 1], N = [−sin U/√D, 0].
    """
    cos_u, sin_u = fourier_pair(X, M_map, b_map, inv_sqrt_D)
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    return torch.cat([cos_u, ones, sin_u, torch.zeros_like(ones)], dim=1)


def clip_classifier_residuals(e: torch.Tensor, y: torch.Tensor, is_classifier: bool) -> torch.Tensor:
    """Zero the residuals of confidently-correct classifications (ref ``:153-155``)."""
    if not is_classifier:
        return e
    y_b = y if e.ndim == 1 else y[:, None]
    return torch.where(((y_b > 0) & (e > 0)) | ((y_b < 0) & (e < 0)), torch.zeros_like(e), e)


def sweep_objective(e: torch.Tensor, s: torch.Tensor, is_classifier: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-abs-LOO error and the γ-selection objective (ref ``:158-165``)."""
    abs_e = torch.abs(e)
    loo_err = s @ abs_e
    if is_classifier:
        objective = s @ (abs_e >= 1).to(e.dtype) + s @ torch.clamp(abs_e - 1, min=0.0) + loo_err
    else:
        objective = loo_err
    return loo_err, objective
