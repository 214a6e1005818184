"""The plain reference of the supervised pre-transform's first stage and of its operands.

The affine normalizer (the reference package's ``_affine_normalizer.py``) bins the rows by
target, takes each bin's weighted median and mean absolute deviation per column, and
combines every pair of bins into one shift and one scale per column. The device
pre-transform bins a classifier by its two labels and a regressor into 8 bins of equal
weighted mass; a median is the average of the lower and upper weighted-ECDF
interpolations at one half. Here that is worked out again by sorting each column of each
bin, in ``mode``'s arithmetic (``lssvm.MODES``): the sums of deviations are one product of
the bins' indicator with the deviations, as a control would compute them in its precision.

:func:`fold` is the last stage, the feature map's operands M = (A·Z)/scale and
b = -(shift/scale)·(A·Z) from the separator's basis A and the Fourier frequencies Z.
"""

import numpy as np
import torch

from perfbench.reference.lssvm import arithmetic

REGRESSION_BINS = 8


def _interp_at(q: torch.Tensor, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """np.interp(q, p, v) for one scalar q and an increasing p."""
    i = int(torch.searchsorted(p, q, right=True))
    if i == 0:
        return v[0]
    if i >= len(p):
        return v[-1]
    p0, p1, v0, v1 = p[i - 1], p[i], v[i - 1], v[i]
    return v0 if p1 == p0 else v0 + (q - p0) / (p1 - p0) * (v1 - v0)


def weighted_quantile(values: torch.Tensor, weights: torch.Tensor, q: float) -> torch.Tensor:
    """The average of the lower and upper weighted-ECDF interpolations at q, in float64."""
    order = torch.argsort(values, stable=True)
    v, w = values[order].double(), weights[order].double()
    cw = torch.cumsum(w, 0)
    total = cw[-1]
    qt = torch.tensor(q, dtype=torch.float64, device=v.device)
    return 0.5 * (_interp_at(qt, (cw - w) / total, v) + _interp_at(qt, cw / total, v))


def target_codes(y: torch.Tensor, is_classifier: bool) -> tuple[torch.Tensor, int]:
    """Each row's bin and the number of bins: the label for a classifier (y = ±1), else the
    index among the 8 equal-mass bins, cut at the target's k/8 quantiles."""
    if is_classifier:
        return (y > 0).long(), 2
    w = torch.ones_like(y)
    edges = torch.stack([weighted_quantile(y, w, k / REGRESSION_BINS) for k in range(1, REGRESSION_BINS)])
    return torch.searchsorted(edges, y.double().contiguous(), right=True), REGRESSION_BINS


def normalizer(
    X_host: np.ndarray, y_signed: np.ndarray, *, is_classifier: bool, mode: str, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """(shift, scale) per column, as NumPy float64, of rows with unit weights."""
    y = torch.from_numpy(np.asarray(y_signed, dtype=np.float64)).to(device)
    codes, num_bins = target_codes(y, is_classifier)
    d = X_host.shape[1]
    med = torch.zeros((num_bins, d), dtype=torch.float64, device=device)
    sigma = torch.zeros_like(med)
    totals = torch.zeros(num_bins, dtype=torch.float64, device=device)
    with arithmetic(mode) as dtype:
        for j in range(d):
            col = torch.from_numpy(np.ascontiguousarray(X_host[:, j])).to(device)
            for b_idx in range(num_bins):
                values = col[codes == b_idx]
                if len(values) == 0:
                    continue
                totals[b_idx] = len(values)
                med[b_idx, j] = weighted_quantile(values, torch.ones_like(values), 0.5)
            # Σ_rows [code == bin]·|x - median(bin)|: one product, in the mode's arithmetic
            onehot = (codes[:, None] == torch.arange(num_bins, device=device)[None, :]).to(dtype)
            deviation = (col.double() - med[codes, j]).abs().to(dtype)
            sigma[:, j] = (onehot.T @ deviation[:, None])[:, 0].double()
            del onehot, deviation
    valid = totals > 0
    sigma = sigma / totals.clamp_min(1.0)[:, None]
    eps = np.finfo(X_host.dtype).eps
    diff = med[None, :, :] - med[:, None, :]  # (i, j, d): μⱼ - μᵢ
    sum_sigma = (sigma[:, None, :] + sigma[None, :, :]).clamp_min(eps)
    separability = diff.abs() / sum_sigma
    w_pair = torch.sqrt((totals[:, None, None] + totals[None, :, None]) * (0.5 + separability))
    alpha = (sigma[:, None, :] / sum_sigma).clamp(1e-6, 1.0 - 1e-6)
    index = torch.arange(num_bins, device=device)
    pairs = ((index[:, None] < index[None, :]) & valid[:, None] & valid[None, :])[:, :, None]
    w_pair = torch.where(pairs, w_pair, 0.0)
    total_w = w_pair.sum(dim=(0, 1))
    shift = (w_pair * (med[:, None, :] + alpha * diff)).sum(dim=(0, 1)) / total_w
    scale = (w_pair * sum_sigma).sum(dim=(0, 1)) / total_w
    direction = (w_pair * torch.sign(diff)).sum(dim=(0, 1))
    scale = torch.where(direction < 0, -scale, scale)
    return shift.cpu().numpy(), scale.cpu().numpy()


def fold(
    A: np.ndarray, Z: np.ndarray, shift: np.ndarray, scale: np.ndarray, *, mode: str, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """(M, b) of the feature phases U = X·M + b, as NumPy float64: the standardisation
    (x - shift)/scale, then the separator's basis A, then the frequencies Z."""
    with arithmetic(mode) as dtype:
        to = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
        folded = to(A) @ to(Z)
        inv_scale = 1.0 / to(scale).reshape(-1)
        M = folded * inv_scale[:, None]
        b = -(to(shift).reshape(1, -1) * inv_scale[None, :]) @ folded
    return M.double().cpu().numpy(), b.double().cpu().numpy().reshape(-1)
