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

On a mesh (``parallel/mesh.py::sharded_device_pre_transform``) each rank passes its own
block of X's rows and the whole y and w, with hooks that complete every sum over X's rows
across the ranks; the random inputs are drawn once (:func:`draw_pretransform_inputs`) and
sent to every rank, so every sampled row index is global.

Its float32 products are IEEE float32 whatever the caller set (``utils/precision.py``).
"""

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from neo_ls_svm_torch.ops.affine import _identity, _normalizer_stats_device
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile_torch
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_torch.utils.profiling import span

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


def draw_shapes(
    d: int,
    *,
    num_bins: int,
    num_features: int,
    edge_sample_size: int,
    edge_search_multiplier: int,
    is_classifier: bool,
    orthogonal: bool = True,
) -> dict[str, tuple[int, ...]]:
    """The shape of each random input of :func:`device_pre_transform` on d columns.

    With exactly two bins each bin's complement is the other bin, so a classifier spends
    4/3 of the edge sample budget (ref _affine_separator.py:138-139).
    """
    ess = int(edge_sample_size * 4 / 3) if is_classifier else edge_sample_size
    m = ess * edge_search_multiplier
    width = num_bins * d
    shapes = {
        "bin_sample": (num_bins, ess),
        "complement": (num_bins, m),
        "bin_pool": (num_bins, m),
        "Z": (width, num_features),
    }
    if orthogonal:
        shapes["chi_normals"] = (width, num_features)
    return shapes


def draw_pretransform_inputs(
    generator: torch.Generator | None,
    shapes: dict[str, tuple[int, ...]],
    dtype: torch.dtype,
    device: torch.device,
) -> dict[str, torch.Tensor]:
    """The random inputs of :func:`device_pre_transform`, drawn from ``generator``.

    The generator is consumed in one fixed order: for each bin its edge sample, complement
    and bin-pool uniforms in [0, 1), then the Gaussian Z, then the normals of the χ rescale
    (orthogonal maps only). So a mesh that draws here once, on one rank, gets what one GPU
    with that seed gets.
    """

    def uniforms(name: str, b_idx: int) -> torch.Tensor:
        return torch.rand(shapes[name][1], generator=generator, dtype=dtype, device=device)

    per_bin = [
        {name: uniforms(name, b_idx) for name in ("bin_sample", "complement", "bin_pool")}
        for b_idx in range(shapes["bin_sample"][0])
    ]
    draws = {name: torch.stack([row[name] for row in per_bin]) for name in per_bin[0]}
    for name in ("Z", "chi_normals"):
        if name in shapes:
            draws[name] = torch.randn(shapes[name], generator=generator, dtype=dtype, device=device)
    return draws


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
    row_sum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    row_gather: Callable[[torch.Tensor], torch.Tensor] = _identity,
    row_start: int = 0,
) -> dict[str, torch.Tensor]:
    """Binning → normalizer statistics → separator → ORFF fold, on the device of ``X``.

    Returns the solver operands ``M`` (d×D) and ``b`` (1×D) with U = X@M + b the feature
    phases, plus the fitted pre-transform state (shift/scale/A/Z and the folded A@Z).
    Mirrors the host pipeline ``AffineSeparator.fit`` →
    ``OrthogonalRandomFourierFeatures.fit`` (ref ``_affine_separator.py:107-210``,
    ``_feature_maps.py:206-223``) with the deviations documented in the module docstring.

    The random inputs come from ``draws`` where given, else from ``generator`` (a generator
    on the device of ``X``) through :func:`draw_pretransform_inputs`: ``"bin_sample"``
    (num_bins, ess), ``"complement"`` and ``"bin_pool"`` (num_bins, ess·multiplier)
    uniforms in [0, 1) for the edge samples, ``"Z"`` (num_bins·d, D) standard normals, and
    for the χ rescale either ``"chi"`` (1, D) χ² variates or ``"chi_normals"``
    (num_bins·d, D) standard normals, whose squares are summed over the kept rank; ess is
    the classifier-adjusted edge sample size (:func:`draw_shapes`).

    On a mesh ``X`` is this rank's block of rows, rows ``row_start`` to
    ``row_start + len(X)`` of ``y`` and ``w``, which are whole: ``row_sum`` completes each
    sum over X's rows across the ranks and ``row_gather`` stacks the ranks' partials
    (:func:`~neo_ls_svm_torch.ops.affine.grouped_weighted_median`). A sampled row is taken
    from the rank that holds it and summed over the ranks, zeros from every other: exact.
    The bins, their masses and the row draws use only y and w, so they are the same on
    every rank and as on one device. The defaults are one device's.

    Every product here must run in IEEE arithmetic, and does: the function runs inside
    ``matmul_precision("ieee")`` whatever the caller set.
    """
    with span("neo.pretransform", device=X.device):
        n_held, d = X.shape
        dtype, dev = X.dtype, X.device
        tiny = torch.finfo(dtype).tiny
        if draws is None:
            shapes = draw_shapes(
                d,
                num_bins=num_bins,
                num_features=num_features,
                edge_sample_size=edge_sample_size,
                edge_search_multiplier=edge_search_multiplier,
                is_classifier=is_classifier,
                orthogonal=orthogonal,
            )
            draws = draw_pretransform_inputs(generator, shapes, dtype, dev)
        draws = {  # a copy of an array: it may be read-only
            k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)).to(dev, dtype)
            for k, v in draws.items()
        }

        with span("neo.pretransform.normalizer", device=X.device):
            codes, totals = _target_codes(y, w, num_bins=num_bins, is_classifier=is_classifier)
            valid = totals > 0
            degenerate = valid.sum() < 2

            held = slice(row_start, row_start + n_held)
            shift, scale = _normalizer_stats_device(
                X, w[held], codes[held], totals, num_bins=num_bins, row_sum=row_sum, row_gather=row_gather
            )
            shift = torch.where(degenerate, torch.zeros_like(shift), shift)
            scale = torch.where(degenerate, torch.ones_like(scale), scale)
            inv_scale = 1.0 / scale

        def take_rows(idx: torch.Tensor) -> torch.Tensor:
            local = idx - row_start
            here = (local >= 0) & (local < n_held)
            return row_sum(torch.where(here[:, None], X[local.clamp(0, n_held - 1)], 0.0))

        ess = draws["bin_sample"].shape[1]

        # Each bin's edge sample, complement sample and bin pool: row indices drawn from y and w
        # alone, so all of them are taken from X at once (on a mesh, one sum over the ranks).
        sampled = []
        for b_idx in range(num_bins):
            in_bin = (codes == b_idx).to(dtype)
            in_comp = ((codes != b_idx) & (codes < num_bins)).to(dtype)
            cum_bin = torch.cumsum(w * in_bin, dim=0)
            cum_comp = torch.cumsum(w * in_comp, dim=0)
            for name, cum in (("bin_sample", cum_bin), ("complement", cum_comp), ("bin_pool", cum_bin)):
                sampled.append(_sample_rows(draws[name][b_idx], cum))
        rows = (take_rows(torch.cat(sampled)) - shift[None, :]) * inv_scale[None, :]
        rows = [r.clone() for r in rows.split([len(i) for i in sampled])]

        edges_in = []
        edges_out = []
        for b_idx in range(num_bins):
            bin_sample, comp_sample, bin_pool = rows[3 * b_idx : 3 * b_idx + 3]
            # Round 1: complement points nearest the bin sample = the complement edge.
            comp_edge = comp_sample[torch.argmin(_sq_dists(bin_sample, comp_sample), dim=1)]
            # Round 2: bin points nearest the complement edge = the bin's own edge.
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
        Z = draws["Z"]
        if orthogonal:
            Z = torch.cat([torch.linalg.qr(Z[:, j : j + width])[0] for j in range(0, D, width)], dim=1)
            chi = draws.get("chi")
            if chi is None:
                # χ df = the effective column count of A (d on the degenerate fallback),
                # matching the host draw's A.shape[1]. df is an integer ≤ width, so a masked
                # sum of squared normals is exact and needs no host read of df.
                chi_df = torch.where(degenerate, torch.full_like(kept_rank, float(d)), kept_rank).clamp_min(1.0)
                normals = draws["chi_normals"]
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
