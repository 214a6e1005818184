"""Supervised affine pre-transform stack (host NumPy fit).

Re-implements the reference's inheritance chain ``AffineFeatureMap`` →
``AffineNormalizer`` → ``AffineSeparator`` (ref ``_affine_feature_map.py``,
``_affine_normalizer.py``, ``_affine_separator.py``). *Fitting* is data-dependent-shape
host NumPy (target binning produces a variable number of bins, the separator's SVD rank
cut is data-dependent), while *transforms* are linear maps that fold into the downstream
feature map and run on the GPU as part of one product (see
:meth:`AffineFeatureMap.linear_form`).

A copy of the host path of ``neo_ls_svm_tpu.ops.affine``: the normalizer always computes
its per-bin statistics with NumPy here (the JAX package's device statistics wait for the
port of the device pre-transform).

RNG parity: the separator draws its edge samples from ``np.random.RandomState`` in the
same call order as the reference, so fitted parameters match bit-for-bit for a given
``random_state``.
"""

from typing import Any

import numpy as np
import numpy.typing as npt

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
