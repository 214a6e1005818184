"""Supervised pre-transform on the solver's device: ``NeoLSSVM(pre_transform="device")``.

The host pre-transform (``ops/affine.py``, ``ops/orff.py``) reproduces the reference bit for
bit: NumPy RNG in the reference's call order, adaptive quantized-ECDF target binning, host
argsorts for the normalizer statistics (ref ``_affine_normalizer.py:50-117``,
``_affine_separator.py:107-210``, ``_feature_maps.py:206-223``). On a large fit that host
work is most of the wall clock. This module is the same pipeline as functions on tensors:
target binning, the normalizer's per-bin statistics, the separator's edge sampling,
eigendecomposition and λ rescale, and the ORFF draw all run on the device of ``X``, with no
host read of a tensor value and no shape that depends on one. The solver consumes the
returned operands directly; the fitted state goes to the host once, with the solver's result.

Counterpart of ``neo_ls_svm_tpu.ops.pretransform_device``, with its deviations from the
bit-parity path (statistically equivalent):

- **Binning**: equal-weighted-mass quantile bins (a fixed count, 8) instead of the adaptive
  quantized-ECDF knots. The reference's ECDF binning targets bins of at most 12.5% mass
  (``_quantizer.py:98-104``); equal-mass-1/8 bins are its limit case with a fixed shape.
  Classifiers use the two label bins exactly as the reference does.
- **RNG**: a ``torch.Generator`` instead of NumPy MT19937 (and instead of the JAX
  package's threefry), so edge samples, the ORFF Gaussian and the χ rescale differ sample
  for sample from both but not in distribution. ``draws`` injects the random inputs, which
  is how the tests hold this module against the JAX one.
- **Ties/summation order**: medians come from the sort-free bisection of
  :func:`~neo_ls_svm_torch.ops.affine.grouped_weighted_median`.

Its float32 products are IEEE float32 whatever the caller set (``utils/precision.py``).
"""

from typing import Any

import numpy as np
import torch

from neo_ls_svm_torch.ops.affine import _normalizer_stats_device
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile_torch
from neo_ls_svm_torch.utils.precision import matmul_precision

DEVICE_PRETRANSFORM_BINS = 8  # Equal-mass target bins for regression (see module doc).


def _target_codes(
    y: torch.Tensor, w: torch.Tensor, *, num_bins: int, is_classifier: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row bin codes and per-bin total weights.

    Counterpart of ``sample_bins_quantized_ecdf`` (ref ``_quantizer.py:246-253``) under the
    equal-mass redesign: regression targets are cut at the weighted ``k/num_bins``
    quantiles; classifiers (y ∈ {−1, +1}) use the two label bins. Zero-weight (padding)
    rows receive code ``num_bins`` and are excluded everywhere.
    """
    if is_classifier:
        codes = (y > 0).to(torch.int32)
    else:
        probs = torch.arange(1, num_bins, dtype=y.dtype, device=y.device) / num_bins
        edges = weighted_quantile_torch(y, w, probs)  # monotone in q → sorted
        codes = torch.searchsorted(edges, y.contiguous(), right=True).to(torch.int32)
    codes = torch.where(w > 0, codes, num_bins)
    onehot = codes[:, None] == torch.arange(num_bins, dtype=torch.int32, device=y.device)[None, :]
    totals = (onehot.to(y.dtype) * w[:, None]).sum(dim=0)
    return codes, totals


def _sample_rows(u: torch.Tensor, cum_mass: torch.Tensor) -> torch.Tensor:
    """One row index per uniform ``u`` ∈ [0, 1), drawn with replacement ∝ the masses
    behind ``cum_mass``.

    Inverse-CDF sampling (one cumsum + searchsorted) replaces the reference's
    ``RandomState.choice`` (ref ``_affine_separator.py:142-167``): O(n + num·log n).
    """
    idx = torch.searchsorted(cum_mass, u * cum_mass[-1], right=False)
    return idx.clamp(0, cum_mass.shape[0] - 1)


def _sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances (rows of A × rows of B)."""
    return (A * A).sum(dim=1, keepdim=True) - 2.0 * A @ B.T + (B * B).sum(dim=1, keepdim=True).T


@matmul_precision("ieee")
def device_pre_transform(
    X: torch.Tensor,  # (n_pad, d) feature rows; padding rows have weight 0
    y: torch.Tensor,  # (n_pad,) targets (±1 for classifiers)
    w: torch.Tensor,  # (n_pad,) sample weights, 0 on padding rows
    generator: torch.Generator | None = None,
    *,
    num_bins: int,
    num_features: int,  # D — the ORFF feature count
    edge_sample_size: int,
    edge_search_multiplier: int,
    rank_threshold: float,
    is_classifier: bool,
    orthogonal: bool = True,
    draws: dict[str, Any] | None = None,
) -> dict[str, torch.Tensor]:
    """Binning → normalizer statistics → separator → ORFF fold, on the device of ``X``.

    Returns the solver operands ``M`` (d×D) and ``b`` (1×D) with U = X@M + b the feature
    phases, plus the fitted pre-transform state (shift/scale/A/Z and the folded A@Z).
    Mirrors the host pipeline ``AffineSeparator.fit`` →
    ``OrthogonalRandomFourierFeatures.fit`` (ref ``_affine_separator.py:107-210``,
    ``_feature_maps.py:206-223``) with the deviations documented in the module docstring.

    The random inputs come from ``generator`` (a generator on the device of ``X``), or
    from ``draws`` where given: ``"bin_sample"`` (num_bins, ess), ``"complement"`` and
    ``"bin_pool"`` (num_bins, ess·multiplier) uniforms in [0, 1) for the edge samples,
    ``"Z"`` (num_bins·d, D) standard normals, and ``"chi"`` (1, D) χ² variates, with ess
    the classifier-adjusted edge sample size.

    Every product here must run in IEEE arithmetic, and does: the function runs inside
    ``matmul_precision("ieee")`` whatever the caller set.
    """
    d = X.shape[1]
    dtype, dev = X.dtype, X.device
    tiny = torch.finfo(dtype).tiny
    draws = draws or {}

    def given(name: str) -> "torch.Tensor | None":
        value = draws.get(name)
        if value is None or isinstance(value, torch.Tensor):
            return value
        return torch.from_numpy(np.array(value)).to(dev, dtype)  # a copy: it may be read-only

    def uniform(name: str, b_idx: int, num: int) -> torch.Tensor:
        value = given(name)
        if value is not None:
            return value[b_idx]
        return torch.rand(num, generator=generator, dtype=dtype, device=dev)

    codes, totals = _target_codes(y, w, num_bins=num_bins, is_classifier=is_classifier)
    valid = totals > 0
    degenerate = valid.sum() < 2

    shift, scale = _normalizer_stats_device(X, w, codes, totals, num_bins=num_bins)
    shift = torch.where(degenerate, torch.zeros_like(shift), shift)
    scale = torch.where(degenerate, torch.ones_like(scale), scale)
    inv_scale = 1.0 / scale

    def norm_rows(idx: torch.Tensor) -> torch.Tensor:
        return (X[idx] - shift[None, :]) * inv_scale[None, :]

    # With exactly two bins each bin's complement is the other bin; spend the sample
    # budget accordingly (ref _affine_separator.py:138-139). The regression bin count is
    # a constant > 2.
    ess = edge_sample_size
    if is_classifier:
        ess = int(ess * 4 / 3)
    m = ess * edge_search_multiplier

    edges_in = []
    edges_out = []
    for b_idx in range(num_bins):
        in_bin = (codes == b_idx).to(dtype)
        in_comp = ((codes != b_idx) & (codes < num_bins)).to(dtype)
        cum_bin = torch.cumsum(w * in_bin, dim=0)
        cum_comp = torch.cumsum(w * in_comp, dim=0)
        bin_sample = norm_rows(_sample_rows(uniform("bin_sample", b_idx, ess), cum_bin))
        comp_sample = norm_rows(_sample_rows(uniform("complement", b_idx, m), cum_comp))
        # Round 1: complement points nearest the bin sample = the complement edge.
        comp_edge = comp_sample[torch.argmin(_sq_dists(bin_sample, comp_sample), dim=1)]
        # Round 2: bin points nearest the complement edge = the bin's own edge.
        bin_pool = norm_rows(_sample_rows(uniform("bin_pool", b_idx, m), cum_bin))
        bin_edge = bin_pool[torch.argmin(_sq_dists(comp_edge, bin_pool), dim=1)]
        edges_in.append(bin_edge)
        edges_out.append(comp_edge)
    # Leading right singular vectors of each bin's edge differences, via the d×d Grams
    # (ref _faster_svd, _affine_separator.py:32-51), all bins in one batched eigh. The
    # data-dependent rank cut is a column mask: dropped directions are zeroed, not
    # removed, so the block width stays d.
    Ediff = torch.stack(edges_in) - torch.stack(edges_out)  # (B, ess, d)
    e, V = torch.linalg.eigh(Ediff.mT @ Ediff)
    s = torch.sqrt(e.abs()).flip(-1)
    V = V.flip(-1)
    keep = ((s > rank_threshold * s[:, :1]) & valid[:, None]).to(dtype)  # (B, d)
    A_sep = (V * keep[:, None, :]).permute(1, 0, 2).reshape(d, num_bins * d)
    # Effective column count after the rank cut: the host ORFF draws its χ degrees of
    # freedom from A.shape[1] AFTER dropped directions are removed (ref
    # _feature_maps.py:221-222 with A_ from _affine_separator.py:173-176); here they are
    # zeroed, so the χ df must count only the kept columns.
    kept_rank = keep.sum()

    # Global rescale λ = √(2·log(f/g)/(f−g)) from mean inter-/intra-bin edge distances
    # (ref _affine_separator.py:178-209). Empty bins contribute weight 0.
    num_inter_pairs = ess * (ess + 1) / 2
    num_intra_pairs = ess * (ess - 1) / 2
    inter = torch.zeros((), dtype=dtype, device=dev)
    intra = torch.zeros((), dtype=dtype, device=dev)
    for b_idx in range(num_bins):
        proj_in = edges_in[b_idx] @ A_sep
        proj_out = edges_out[b_idx] @ A_sep
        inter = inter + totals[b_idx] * torch.tril(_sq_dists(proj_in, proj_out)).sum() / num_inter_pairs
        intra = intra + totals[b_idx] * torch.tril(_sq_dists(proj_in, proj_in), diagonal=-1).sum() / num_intra_pairs
    total_mass = totals.sum().clamp_min(tiny)
    inter = inter / total_mass
    intra = intra / total_mass
    gap = inter - intra
    # As inter → intra the exact expression 2·log(f/g)/(f−g) tends to 2/g.
    ratio = torch.where(
        gap.abs() > 1e3 * tiny,
        2.0 * torch.log(inter.clamp_min(tiny) / intra.clamp_min(tiny)) / gap,
        2.0 / intra.clamp_min(tiny),
    )
    lam = torch.where(intra > 0, torch.sqrt(ratio.clamp_min(0.0)), torch.ones_like(ratio))
    A_sep = A_sep * lam

    # Fewer than two populated bins: the separator is undefined. Degrade to the
    # unsupervised identity metric (shift 0 / scale 1 set above), mirroring the host
    # path's 1-bin early exit (ref _affine_separator.py:135-136).
    width = num_bins * d
    ident = torch.zeros((d, width), dtype=dtype, device=dev)
    ident[:, :d] = torch.eye(d, dtype=dtype, device=dev)
    A_final = torch.where(degenerate, ident, A_sep)

    # Random Fourier draw. ``orthogonal`` (OrthogonalRandomFourierFeatures, the default)
    # applies blockwise QR orthogonalisation with χ-rescaled column norms (ref
    # _feature_maps.py:206-223, following Yu et al. 2016); a plain RandomFourierFeatures
    # map keeps the i.i.d. N(0,1) draw it was configured with (ref :120-127).
    D = num_features
    Z = given("Z")
    if Z is None:
        Z = torch.randn((width, D), generator=generator, dtype=dtype, device=dev)
    if orthogonal:
        Z = torch.cat([torch.linalg.qr(Z[:, j : j + width])[0] for j in range(0, D, width)], dim=1)
        chi = given("chi")
        if chi is None:
            # χ df = the effective column count of A (d on the degenerate fallback),
            # matching the host draw's A.shape[1]. df is an integer ≤ width, so a masked
            # sum of squared normals is exact and needs no host read of df.
            chi_df = torch.where(degenerate, torch.full_like(kept_rank, float(d)), kept_rank).clamp_min(1.0)
            normals = torch.randn((width, D), generator=generator, dtype=dtype, device=dev)
            counted = torch.arange(width, dtype=dtype, device=dev)[:, None] < chi_df
            chi = (normals * normals * counted).sum(dim=0, keepdim=True)
        Z = Z * torch.sqrt(chi)

    folded = A_final @ Z  # (d, D)
    return {
        "M": folded * inv_scale[:, None],
        "b": -(shift * inv_scale)[None, :] @ folded,
        "pt_shift": shift[None, :],
        "pt_scale": scale[None, :],
        "pt_A": A_final,
        "pt_Z": Z,
        "pt_folded": folded,
    }
