"""Supervised affine pre-transform stack (host NumPy fit), and the normalizer's per-bin
statistics on tensors for the on-device pre-transform.

Re-implements the reference's inheritance chain ``AffineFeatureMap`` →
``AffineNormalizer`` → ``AffineSeparator`` (ref ``_affine_feature_map.py``,
``_affine_normalizer.py``, ``_affine_separator.py``). *Fitting* is data-dependent-shape
host NumPy (target binning produces a variable number of bins, the separator's SVD rank
cut is data-dependent), while *transforms* are linear maps that fold into the downstream
feature map and run on the GPU as part of one product (see
:meth:`AffineFeatureMap.linear_form`).

A copy of the host path of ``neo_ls_svm_tpu.ops.affine``: the host normalizer computes its
per-bin statistics with NumPy at every size. :func:`grouped_weighted_median` and
:func:`_normalizer_stats_device` are the same statistics on tensors, sort-free and with no
host read; ``ops/pretransform_device.py`` calls them.

RNG parity: the separator draws its edge samples from ``np.random.RandomState`` in the
same call order as the reference, so fitted parameters match bit-for-bit for a given
``random_state``.
"""

from collections.abc import Callable
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.ops.quantizer import sample_bins_quantized_ecdf
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile
from neo_ls_svm_torch.utils.base import BaseEstimator, TransformerMixin
from neo_ls_svm_torch.utils.validation import (
    check_array,
    check_consistent_length,
    check_random_state,
    check_X_y,
)


def squared_distances(X: npt.NDArray, Y: npt.NDArray) -> npt.NDArray:
    """Pairwise squared Euclidean distances between rows of X and Y (host NumPy).

    Matmul-based expansion as in the reference (``_affine_separator.py:16-21``).
    """
    return (
        np.sum(X * X, axis=1, keepdims=True)
        - 2 * X @ Y.T
        + np.sum(Y * Y, axis=1, keepdims=True).T
    )


def nearest_neighbours(X: npt.NDArray, Y: npt.NDArray) -> npt.NDArray:
    """For each row of X, the nearest row of Y (ref ``_affine_separator.py:24-29``)."""
    idx = np.argmin(squared_distances(X, Y), axis=1, keepdims=True)
    return np.take_along_axis(Y, idx, axis=0)


def right_singular_vectors(X: npt.NDArray) -> tuple[npt.NDArray, npt.NDArray]:
    """Singular values and right singular vectors via the smaller-side Gram eigh.

    Equivalent to ``np.linalg.svd(X)[1:]`` transposed, but eigendecomposes whichever of
    XᵀX / XXᵀ is smaller (ref ``_faster_svd``, ``_affine_separator.py:32-51``).
    """
    if X.shape[0] >= X.shape[1]:
        e, V = np.linalg.eigh(X.conj().T @ X)
        s = np.sqrt(np.abs(e))[::-1]
        V = V[:, ::-1]
    else:
        e, U = np.linalg.eigh(X @ X.conj().T)
        s = np.sqrt(np.abs(e))[::-1]
        U = U[:, ::-1]
        keep = s > 0
        s, U = s[keep], U[:, keep]
        V = (X.conj().T @ U) / s[np.newaxis, :]
    return s, V


class AffineFeatureMap(BaseEstimator, TransformerMixin):
    """Parametrised affine feature map ``x ↦ (x - shift) @ diag(1/scale) @ A``.

    With ``append_features=True`` and an ``A``, the transformed features are appended to
    the input features (ref ``_affine_feature_map.py:17-25``).
    """

    def __init__(
        self,
        *,
        scale: Any,
        shift: Any,
        A: npt.NDArray | None = None,
        append_features: bool = False,
    ):
        self.scale = scale
        self.shift = shift
        self.A = A
        self.append_features = append_features

    def _effective_params(self, num_features: int) -> tuple[npt.NDArray, npt.NDArray, Any]:
        scale = np.reshape(getattr(self, "scale_", self.scale), (-1, num_features))
        shift = np.reshape(getattr(self, "shift_", self.shift), (-1, num_features))
        A = getattr(self, "A_", self.A)
        return scale, shift, A

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Validate the (given or learned) parameters against X; no learning here."""
        X = check_array(X)
        self.n_features_in_ = X.shape[1]
        scale, shift, A = self._effective_params(X.shape[1])
        assert scale.dtype == shift.dtype, "The scale and shift must have the same dtype"
        assert not np.any(scale == 0), "The scale may not be zero"
        assert np.all(np.isfinite(scale)), "The scale must be finite"
        assert np.all(np.isfinite(shift)), "The shift must be finite"
        assert X.shape[1] == scale.shape[1], "The scale must match the number of features"
        assert X.shape[1] == shift.shape[1], "The shift must match the number of features"
        if A is not None:
            assert A.dtype == scale.dtype, "A must share the scale/shift dtype"
            assert X.shape[1] == A.shape[0], "A must have one row per feature of X"
            assert np.all(np.isfinite(A)), "The matrix A must be finite"
        return self

    def linear_form(self, num_features: int) -> tuple[npt.NDArray | None, npt.NDArray, npt.NDArray]:
        """Return ``(M, offset, inv_scale)`` so the map is ``X @ M + offset`` when ``M``
        is not None, else ``(X - shift) * inv_scale``.

        This is what gets folded into the downstream random-features product so the
        whole pre-transform rides a single contraction on the device.
        """
        scale, shift, A = self._effective_params(num_features)
        if A is None:
            return None, shift, 1.0 / scale
        M = A / scale.T
        offset = -shift @ M
        return M, offset, 1.0 / scale

    def transform(self, X: npt.NDArray) -> npt.NDArray:
        """Apply the affine map (host path; the device path uses ``linear_form``)."""
        X = check_array(X)
        scale, shift, A = self._effective_params(X.shape[1])
        if A is None:
            out = (X - shift) / scale
        elif A.shape[1] < A.shape[0]:
            # Tall A: scale/shift folded into A to avoid materialising (X - shift).
            out = X @ (A / scale.T) - shift @ (A / scale.T)
        else:
            out = (X - shift) @ (A / scale.T)
        out = out.astype(X.dtype)
        if self.append_features and A is not None:
            out = np.hstack((X, out))
        return out

    @property
    def pseudo_inverse(self) -> npt.NDArray | None:
        """Pseudo-inverse of the effective transformation matrix A (lazily cached)."""
        A = getattr(self, "A_", self.A)
        if A is None:
            return None
        cached = getattr(self, "_pseudo_inverse_cache", None)
        if cached is None or cached[0] is not A:
            cached = (A, np.linalg.pinv(A))
            self._pseudo_inverse_cache = cached
        return cached[1]

    def inverse_transform(self, X_transformed: npt.NDArray) -> npt.NDArray:
        """Approximately invert this transformation."""
        X = check_array(X_transformed)
        A = getattr(self, "A_", self.A)
        num_features = X.shape[1] if A is None else A.shape[0]
        scale, shift, A = self._effective_params(num_features)
        if self.append_features and A is not None:
            return X[:, : A.shape[0]]
        if A is not None:
            X = X @ self.pseudo_inverse
        return (X * scale + shift).astype(X.dtype)

    def get_feature_names_out(
        self, input_features: npt.ArrayLike | None = None
    ) -> npt.NDArray[np.object_]:
        """Get output feature names for the transformation."""
        A = getattr(self, "A_", self.A)
        if input_features is None:
            n = getattr(self, "n_features_in_", A.shape[0] if A is not None else 1)
            input_features = [f"x{j}" for j in range(n)]
        feats = np.asarray(input_features, dtype=object)
        if A is None:
            out = np.array([f"{f}_shifted_scaled" for f in feats], dtype=object)
        else:
            joined = ",".join(str(f) for f in feats)
            out = np.array([f"{joined}_affine_map"] * A.shape[1], dtype=object)
        if self.append_features and A is not None:
            out = np.hstack((feats, out))
        return out


class AffineNormalizer(AffineFeatureMap):
    """Supervised affine normalizer: learns per-feature shift and scale so that the
    difference between samples from two target bins equals the bins' separability.

    For every pair of target bins (i, j) with weighted-median centres μ and weighted
    mean-absolute-deviations σ, the optimal threshold ``μᵢ + α(μⱼ-μᵢ)`` with
    ``α = clip(σᵢ/(σᵢ+σⱼ))`` and the spread ``σᵢ+σⱼ`` are accumulated with weight
    ``√((nᵢ+nⱼ)(0.5 + |μⱼ-μᵢ|/(σᵢ+σⱼ)))`` (ref ``_affine_normalizer.py:50-117``).
    """

    def __init__(self, *, append_features: bool = False) -> None:
        self.shift = 0.0
        self.scale = 1.0
        self.A = None
        self.append_features = append_features

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Learn the shift and scale from binned targets."""
        X, y = check_X_y(X, y)
        y = np.ravel(np.asarray(y)).astype(X.dtype)
        weights = (
            np.ones(y.shape) if sample_weight is None else np.ravel(np.asarray(sample_weight))
        ).astype(y.dtype)
        check_consistent_length(y, weights)
        bins, bin_weights, bin_probs = _bin_by_target(y, weights)
        if getattr(self, "_want_bin_cache", False):
            # Hand the binning to the subclass fit (the separator) so the target is
            # quantized once per fit, not once per class in the inheritance chain.
            self._bin_cache = (bins, bin_weights, bin_probs)
        d = X.shape[1]
        if len(bins) <= 1:
            self.shift_ = np.zeros((1, d), dtype=X.dtype)
            self.scale_ = np.ones((1, d), dtype=X.dtype)
            super().fit(X, y, weights)
            return self
        centers = []
        spreads = []
        for mask, probs in zip(bins, bin_probs):
            X_bin = X[mask]  # gather once; both statistics read the same block
            mu = weighted_quantile(X_bin, probs.T, 0.5, axis=0)
            centers.append(mu)
            spreads.append(probs @ np.abs(X_bin - mu))
        sign = np.zeros((1, d), dtype=X.dtype)
        total_w = np.zeros((1, d), dtype=X.dtype)
        self.shift_ = np.zeros((1, d), dtype=X.dtype)
        self.scale_ = np.zeros((1, d), dtype=X.dtype)
        for i in range(len(centers) - 1):
            for j in range(i + 1, len(centers)):
                diff_mu = centers[j] - centers[i]
                sum_sigma = np.maximum(spreads[i] + spreads[j], np.finfo(X.dtype).eps)
                separability = np.abs(diff_mu) / sum_sigma
                w = np.sqrt((bin_weights[i] + bin_weights[j]) * (0.5 + separability))
                alpha = np.clip(spreads[i] / sum_sigma, 1e-6, 1.0 - 1e-6)
                self.shift_ = self.shift_ + w * (centers[i] + alpha * diff_mu)
                self.scale_ = self.scale_ + w * sum_sigma
                sign += w * np.sign(diff_mu)
                total_w += w
        sign /= total_w
        self.shift_ = self.shift_ / total_w
        self.scale_ = self.scale_ / total_w
        flip = np.sign(sign) < 0
        self.scale_[flip] = -self.scale_[flip]
        super().fit(X, y, weights)
        return self


def _bin_by_target(
    y: npt.NDArray, weights: npt.NDArray
) -> tuple[list[npt.NDArray], list[np.floating], list[npt.NDArray]]:
    """Quantize y into bins; return per-bin masks, total weights and normalised weights."""
    y_quantized = sample_bins_quantized_ecdf(y)
    lo = np.min(y_quantized)
    masks = [y_quantized == i for i in range(lo, np.max(y_quantized) + 1)]
    totals = [np.sum(weights[m]) for m in masks]
    probs = [weights[np.newaxis, m] / np.sum(weights[m]) for m in masks]
    return masks, totals, probs


def _float_to_ordered_int(x: torch.Tensor) -> torch.Tensor:
    """Map finite floats to integers with the same total order (IEEE-754 bit trick).

    Non-negative floats compare like their (sign-preserving) bit patterns; negative
    floats compare in reverse, fixed by reflecting them below zero. ±0.0 collide,
    which is correct: they are equal as floats.
    """
    int_dtype = torch.int64 if x.dtype == torch.float64 else torch.int32
    bits = x.contiguous().view(int_dtype)
    return torch.where(bits >= 0, bits, torch.iinfo(int_dtype).min - bits)


def _ordered_int_to_float(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = torch.where(o >= 0, o, torch.iinfo(o.dtype).min - o)
    return bits.view(dtype)


# Rows per block of the normalizer's float64 deviation sums.
DEVIATION_ROWS = 1 << 20


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def grouped_weighted_median(
    X: torch.Tensor,  # (n, d)
    w: torch.Tensor,  # (n,) nonnegative; 0 excludes a row
    codes: torch.Tensor,  # (n,) integer bin codes; codes >= num_bins are excluded
    num_bins: int,
    *,
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    row_gather: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> torch.Tensor:
    """(num_bins, d) weighted medians per (bin, column), sort-free and with no host read.

    Same averaged lower/upper ECDF convention as :func:`weighted_quantile` (ref
    ``_weighted_quantile.py:56-75``), reconstructed from run-boundary masses instead
    of per-entry cumulative sums: a bisection in float-bit space (33 steps in f32, 65 in
    f64) finds, per (bin, column), the smallest member value v_hi whose cumulative weight
    reaches half the bin mass; the two ECDF interpolations then only need mass(<v_hi),
    mass(≤v_hi), the run count at v_hi, and the neighbouring member values. All bin-grouped
    masses are one-hot products (n,B)ᵀ@(n,d). They must run in IEEE arithmetic: with TF32
    on, a mass that straddles the half mass flips the bisection. Within a tie run the
    entry weight is taken as the run average, which coincides with any sort order for
    uniform weights.

    The final boundary masses are always taken in float64: mass_le − mass_lt is a single
    entry's weight, a cancellation of two sums of about W/2 each.

    On a mesh the rows are this rank's: ``row_sum`` completes every sum over rows across
    the ranks, and ``row_gather`` stacks each rank's (1, …) partial into (ranks, …) for the
    neighbouring values' max and min. Both are the identity on one device. With unit
    weights every mass is an exact integer, so the medians do not depend on the split.
    """
    d = X.shape[1]
    compute, acc = X.dtype, torch.float64
    onehot = codes[:, None] == torch.arange(num_bins, dtype=codes.dtype, device=X.device)[None, :]
    w_oh = onehot.to(compute) * w[:, None].to(compute)  # (n, B) per-bin weighted indicator
    W = row_sum(w_oh.sum(dim=0))  # (B,)
    t = 0.5 * W
    xo = _float_to_ordered_int(X)  # (n, d) ordered ints, same width as the dtype
    int_dtype = xo.dtype
    lo = torch.full((num_bins, d), torch.iinfo(int_dtype).min, dtype=int_dtype, device=X.device)
    hi = torch.full((num_bins, d), torch.iinfo(int_dtype).max, dtype=int_dtype, device=X.device)
    codes_safe = codes.clamp(0, num_bins - 1).long()  # invalid rows carry w = 0
    for _ in range(65 if X.dtype == torch.float64 else 33):
        # Overflow-safe floor average: the ordered ints span the full integer range.
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        mass = row_sum(w_oh.T @ (xo <= mid[codes_safe]).to(compute))  # (B, d)
        ge = mass >= t[:, None]
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    v_hi = _ordered_int_to_float(hi, X.dtype).to(acc)  # (B, d) crossing member value

    hi_rows = hi[codes_safe]
    le = (xo <= hi_rows).to(acc)
    lt = (xo < hi_rows).to(acc)
    w_oh_acc = w_oh.to(acc)
    mass_le, mass_lt, cnt_run = row_sum(
        torch.stack([w_oh_acc.T @ le, w_oh_acc.T @ lt, onehot.to(acc).T @ (le - lt)])
    )
    # Neighbouring member values around the v_hi run, per bin (num_bins is small).
    v_lo = torch.empty((num_bins, d), dtype=compute, device=X.device)
    v_next = torch.empty((num_bins, d), dtype=compute, device=X.device)
    for b in range(num_bins):
        in_bin = ((codes == b) & (w > 0))[:, None]
        v_lo[b] = torch.where(in_bin & (xo < hi[b][None, :]), X, -torch.inf).amax(dim=0)
        v_next[b] = torch.where(in_bin & (xo > hi[b][None, :]), X, torch.inf).amin(dim=0)
    partials = row_gather(torch.stack([v_lo, v_next])[None])  # (ranks, 2, B, d)
    v_lo, v_next = partials[:, 0].amax(dim=0).to(acc), partials[:, 1].amin(dim=0).to(acc)
    t_acc = t.to(acc)[:, None]
    w_edge = (mass_le - mass_lt) / cnt_run.clamp_min(1.0)
    safe_edge = w_edge.clamp_min(torch.finfo(acc).tiny)
    has_lower = mass_lt > 0
    has_next = (W.to(acc)[:, None] - mass_le) > 0
    # interp(t, p_upper, v): crossing interval is (mass_lt, mass_lt + w_edge] between
    # the last member below the run and the run's first entry; beyond it → v_hi.
    frac_u = (t_acc - mass_lt) / safe_edge
    upper = torch.where((~has_lower) | (frac_u >= 1.0), v_hi, v_lo + frac_u * (v_hi - v_lo))
    # interp(t, p_lower, v): crossing interval is (mass_le - w_edge, mass_le] between
    # the run's last entry and the next member above; before it → v_hi.
    frac_l = (t_acc - (mass_le - w_edge)) / safe_edge
    lower = torch.where((~has_next) | (frac_l <= 0.0), v_hi, v_hi + frac_l * (v_next - v_hi))
    return (0.5 * (upper + lower)).to(X.dtype)


def _normalizer_stats_device(
    X: torch.Tensor,  # (n, d) feature rows
    w: torch.Tensor,  # (n,) sample weights, 0 on padding rows
    codes: torch.Tensor,  # (n,) integer bin codes; excluded rows carry code >= num_bins
    bin_totals: torch.Tensor,  # (num_bins,) total bin weights (0 for empty bins)
    *,
    num_bins: int,
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    row_gather: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin weighted medians/MADs and the pairwise shift/scale accumulation, on tensors.

    Counterpart of the host loop in :meth:`AffineNormalizer.fit` (itself mirroring ref
    ``_affine_normalizer.py:80-114``): medians come from the sort-free bisection in
    :func:`grouped_weighted_median`, the mean absolute deviations from one one-hot
    product, and the O(B²) bin-pair accumulation is a masked broadcast. On a mesh the rows
    are this rank's and the hooks complete the sums over rows, as in
    :func:`grouped_weighted_median`; ``bin_totals`` is already whole.
    """
    eps = torch.finfo(X.dtype).eps
    bin_valid = bin_totals > 0  # (B,)
    med = grouped_weighted_median(X, w, codes, num_bins, row_sum=row_sum, row_gather=row_gather)  # (B, d)
    med = torch.where(bin_valid[:, None], med, 0.0)  # scrub empty-bin values before reuse
    codes_safe = codes.clamp(0, num_bins - 1).long()
    onehot = codes[:, None] == torch.arange(num_bins, dtype=codes.dtype, device=X.device)[None, :]
    w_oh = onehot.to(X.dtype) * w[:, None]
    w_sum = row_sum(w_oh.sum(dim=0)).clamp_min(eps)  # (B,)
    # The deviations are summed in float64 (then rounded once): one float32 product over
    # millions of rows strays from the exact sum in its last bits (7.5e-7 relative at 4M
    # rows on an H100, PERF.md), rows split over ranks stray another way, and an f32 LOO fit
    # feels either; in float64 both round to the same σ. A block of rows at a time, so that
    # no (n, d) float64 copy is made.
    dev_sum = torch.zeros((num_bins, X.shape[1]), dtype=torch.float64, device=X.device)
    for start in range(0, X.shape[0], DEVIATION_ROWS):
        part = slice(start, start + DEVIATION_ROWS)
        deviations = (X[part] - med[codes_safe[part]]).abs().to(torch.float64)
        dev_sum += w_oh[part].to(torch.float64).T @ deviations
    sigma = (row_sum(dev_sum) / w_sum.to(torch.float64)[:, None]).to(X.dtype)
    # Pairwise accumulation over valid bins i < j.
    diff = med[None, :, :] - med[:, None, :]  # (i, j, d): μⱼ - μᵢ
    sum_sigma = (sigma[:, None, :] + sigma[None, :, :]).clamp_min(eps)
    separability = diff.abs() / sum_sigma
    pair_tot = bin_totals[:, None, None] + bin_totals[None, :, None]
    w_pair = torch.sqrt(pair_tot * (0.5 + separability))
    alpha = (sigma[:, None, :] / sum_sigma).clamp(1e-6, 1.0 - 1e-6)
    index = torch.arange(num_bins, device=X.device)
    pair_valid = (
        (index[:, None] < index[None, :]) & bin_valid[:, None] & bin_valid[None, :]
    )[:, :, None]
    w_pair = torch.where(pair_valid, w_pair, 0.0)
    shift = (w_pair * (med[:, None, :] + alpha * diff)).sum(dim=(0, 1))
    scale = (w_pair * sum_sigma).sum(dim=(0, 1))
    sign = (w_pair * torch.sign(diff)).sum(dim=(0, 1))
    total_w = w_pair.sum(dim=(0, 1))
    shift = shift / total_w
    scale = scale / total_w
    scale = torch.where(torch.sign(sign / total_w) < 0, -scale, scale)
    return shift, scale


class AffineSeparator(AffineNormalizer):
    """Affine separator: learns the matrix A that optimally separates target bins.

    After normalising with the inherited shift/scale, each bin's edge is located by two
    rounds of nearest-neighbour search between weighted samples of the bin and its
    complement; the leading right singular vectors of the edge differences become that
    bin's block of A, and a global rescale λ = √(2·log(f/g)/(f−g)) tunes A for Gaussian
    kernels, where f/g are mean inter-/intra-bin edge distances
    (ref ``_affine_separator.py:54-210``; λ derivation at ``:75-87``).
    """

    def __init__(
        self,
        *,
        append_features: bool = False,
        rank_threshold: float = 2e-2,
        edge_sample_size: int = 384,
        edge_search_multiplier: int = 4,
        random_state: Any = 42,
    ) -> None:
        self.shift = 0.0
        self.scale = 1.0
        self.A = None
        self.append_features = append_features
        self.rank_threshold = rank_threshold
        self.edge_sample_size = edge_sample_size
        self.edge_search_multiplier = edge_search_multiplier
        self.random_state = random_state

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Learn shift, scale, and the separating matrix A."""
        assert y is not None
        X, y = check_X_y(X, y)
        y = np.ravel(np.asarray(y)).astype(X.dtype)
        # Learn the shift/scale (reusing its target binning), then work on the
        # normalised features.
        self._want_bin_cache = True
        try:
            AffineNormalizer.fit(self, X, y, sample_weight)
        finally:
            del self._want_bin_cache
        masks, bin_weights, bin_probs = self.__dict__.pop("_bin_cache")
        weights = (
            np.ones(y.shape) if sample_weight is None else np.ravel(np.asarray(sample_weight))
        ).astype(y.dtype)
        check_consistent_length(y, weights)
        if len(masks) <= 1:
            return self
        # Gather-then-normalize: the separator only ever touches O(B·ess) sampled rows,
        # so the shift/scale map is applied to those rows instead of materialising the
        # full normalised n×d matrix on the host (bitwise-identical per element).
        shift = np.reshape(self.shift_, (1, -1)).astype(X.dtype)
        scale = np.reshape(self.scale_, (1, -1)).astype(X.dtype)

        def _normalized_rows(rows: npt.NDArray) -> npt.NDArray:
            return ((X[rows, :] - shift) / scale).astype(X.dtype)

        # With only two bins each bin's complement is the other bin; spend the sample
        # budget accordingly (ref _affine_separator.py:138-139).
        ess = self.edge_sample_size
        if len(masks) == 2:
            ess = int(ess * 4 / 3)
        generator = check_random_state(self.random_state)
        blocks: list[npt.NDArray] = []
        edges_in: list[npt.NDArray] = []
        edges_out: list[npt.NDArray] = []
        bin_rows = [np.flatnonzero(m) for m in masks]
        for i in range(len(bin_rows)):
            idx = generator.choice(len(bin_rows[i]), size=ess, p=np.ravel(bin_probs[i]))
            bin_sample = _normalized_rows(bin_rows[i][idx])
            complement_rows = np.concatenate(
                [rows for j, rows in enumerate(bin_rows) if j != i]
            )
            complement_w = weights[complement_rows]
            idx = generator.choice(
                len(complement_rows),
                size=ess * self.edge_search_multiplier,
                p=np.ravel(complement_w) / np.sum(complement_w),
            )
            complement_sample = _normalized_rows(complement_rows[idx])
            # Round 1: complement points nearest to the bin sample = the complement edge.
            complement_edge = nearest_neighbours(bin_sample, complement_sample)
            edges_out.append(complement_edge)
            # Round 2: bin points nearest to the complement edge = the bin's own edge.
            idx = generator.choice(
                len(bin_rows[i]), size=ess * self.edge_search_multiplier, p=np.ravel(bin_probs[i])
            )
            bin_edge = nearest_neighbours(complement_edge, _normalized_rows(bin_rows[i][idx]))
            edges_in.append(bin_edge)
            # Directions that separate the two edges: leading right singular vectors.
            s, V = right_singular_vectors(bin_edge - complement_edge)
            rank = int(np.sum(s > self.rank_threshold * s[0]))
            blocks.append(V[:, :rank])
        self.A_ = np.hstack(blocks)
        # Rescale A for Gaussian-kernel methods from mean inter/intra-bin edge distances.
        inter, intra = 0.0, 0.0
        num_inter_pairs = ess * (ess + 1) / 2
        num_intra_pairs = ess * (ess - 1) / 2
        for bin_edge, complement_edge, n_bin in zip(edges_in, edges_out, bin_weights):
            proj_in = bin_edge @ self.A_
            proj_out = complement_edge @ self.A_
            inter += n_bin * np.sum(np.tril(squared_distances(proj_in, proj_out), k=0)) / num_inter_pairs
            intra += n_bin * np.sum(np.tril(squared_distances(proj_in, proj_in), k=-1)) / num_intra_pairs
        inter /= sum(bin_weights)
        intra /= sum(bin_weights)
        scale_factor = np.sqrt(2 * np.log(inter / intra) / (inter - intra)) if intra > 0 else 1
        self.A_ = self.A_ * scale_factor
        return self
