"""Kernel matrices on tensors.

Replaces the reference's sklearn ``rbf_kernel`` / ``euclidean_distances`` calls (ref
``_neo_ls_svm.py:11,257-261,321,474,669``): a squared-distance expansion that rides one
matrix product plus rank-1 corrections, with sklearn's exact numerical conventions
(negative clamp; zeroed self-distance diagonal) so that kernel-path results are comparable
at tight tolerances. Counterpart of ``neo_ls_svm_tpu.ops.kernels``.
"""

import torch


def squared_distances(X: torch.Tensor, Y: torch.Tensor, *, same: bool = False) -> torch.Tensor:
    """Pairwise squared Euclidean distances; ``same=True`` zeroes the diagonal
    (sklearn ``euclidean_distances`` convention for X vs X)."""
    xx = (X * X).sum(dim=1, keepdim=True)
    yy = (Y * Y).sum(dim=1, keepdim=True).T
    sq = (xx - 2.0 * (X @ Y.T) + yy).clamp_min(0.0)
    if same:
        sq = sq * (1.0 - torch.eye(X.shape[0], dtype=X.dtype, device=X.device))
    return sq


def rbf_kernel(
    X: torch.Tensor, Y: torch.Tensor, gamma: float = 0.5, *, same: bool = False
) -> torch.Tensor:
    """K(x, y) = exp(-γ·‖x-y‖²); γ = 0.5 throughout the reference's dual/std paths."""
    return torch.exp(-gamma * squared_distances(X, Y, same=same))
