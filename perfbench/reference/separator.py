"""The plain reference of the supervised pre-transform's separator and random Fourier draw.

After the normalizer (``normalizer.py``), the pre-transform that ``NeoLSSVM`` runs on the
device (the reference package's ``_affine_separator.py`` and ``_feature_maps.py``, redesigned
for the device) finds each target bin's edge: it draws an edge sample and a pool from the bin
and a sample from its complement, takes the complement's points nearest the edge sample,
then the bin's points nearest those. The leading right singular vectors of the edge
differences, cut at a relative rank threshold and scaled by one factor λ from the mean
inter- and intra-bin edge distances, make the separator's basis A; Z is the orthogonal
random Fourier draw, QR-orthogonalised in blocks and rescaled by χ variates.

The random inputs are drawn here from a ``torch.Generator`` seeded with the estimator's
``random_state``, on the device and in the rows' dtype, in the order the estimator
documents (``draw_pretransform_inputs``): for each bin its edge-sample, complement and pool
uniforms, then the Gaussian Z, then the χ normals. The draws are the seed's, not the
program's; the same device and seed give the same numbers.

Nearest points are a discrete choice on distances that rounding can reorder. The choice is
made on the distances of the rows standardised by ``select``'s shift and scale, in
``select``'s arithmetic; everything else (the edges' values, the eigendecomposition, λ, the
QR, χ) is worked out in ``mode``'s arithmetic from the rows and the given shift and scale.
"""

import numpy as np
import torch

from perfbench.reference.lssvm import arithmetic


def draw(seed: int, *, d: int, num_bins: int, setting: dict, is_classifier: bool, dtype: torch.dtype,
         device: torch.device) -> dict[str, torch.Tensor]:
    """The pre-transform's random inputs from ``seed``: with exactly two bins each bin's
    complement is the other bin, so a classifier spends 4/3 of the edge sample budget."""
    ess = int(setting["edge_sample_size"] * 4 / 3) if is_classifier else setting["edge_sample_size"]
    m = ess * setting["edge_search_multiplier"]
    width, D = num_bins * d, setting["num_features"]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    sizes = {"bin_sample": ess, "complement": m, "bin_pool": m}
    per_bin = [
        {name: torch.rand(size, generator=generator, dtype=dtype, device=device) for name, size in sizes.items()}
        for _ in range(num_bins)
    ]
    out = {name: torch.stack([row[name] for row in per_bin]) for name in sizes}
    for name in ("Z", "chi_normals"):
        out[name] = torch.randn((width, D), generator=generator, dtype=dtype, device=device)
    return out


def _sample(u: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """One row index per uniform u, drawn with replacement among the rows of ``member``
    (unit weights): the first row whose running count reaches u times the total. The count
    is exact in the uniforms' dtype below 2²⁴ rows a bin, and u times the total is rounded
    there, as a draw in that dtype is."""
    count = torch.cumsum(member.to(torch.int64), 0).to(u.dtype)
    return torch.searchsorted(count, u * count[-1], right=False).clamp(0, len(count) - 1)


def _sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, rows of A × rows of B, by the expansion."""
    return (A * A).sum(dim=1, keepdim=True) - 2.0 * A @ B.T + (B * B).sum(dim=1, keepdim=True).T


def edge_rows(X_host: np.ndarray, codes: torch.Tensor, num_bins: int, draws: dict, select: dict) -> list[tuple]:
    """Per bin, the row indices of its edge and of its complement's edge (on the device)."""
    with arithmetic(select["mode"]) as dtype:
        device = codes.device
        shift = torch.as_tensor(np.asarray(select["shift"]), device=device).to(dtype).reshape(-1)
        inv_scale = 1.0 / torch.as_tensor(np.asarray(select["scale"]), device=device).to(dtype).reshape(-1)

        def standardised(idx: torch.Tensor) -> torch.Tensor:
            rows = torch.from_numpy(X_host[idx.cpu().numpy()]).to(device, dtype)
            return (rows - shift[None, :]) * inv_scale[None, :]

        out = []
        for b_idx in range(num_bins):
            in_bin = codes == b_idx
            i_sample = _sample(draws["bin_sample"][b_idx], in_bin)
            i_comp = _sample(draws["complement"][b_idx], ~in_bin)
            i_pool = _sample(draws["bin_pool"][b_idx], in_bin)
            comp = standardised(i_comp)
            nearest = torch.argmin(_sq_dists(standardised(i_sample), comp), dim=1)
            i_out = i_comp[nearest]
            i_in = i_pool[torch.argmin(_sq_dists(comp[nearest], standardised(i_pool)), dim=1)]
            out.append((i_in, i_out))
        return out


def separator(
    X_host: np.ndarray,
    codes: torch.Tensor,
    totals: torch.Tensor,
    num_bins: int,
    setting: dict,
    *,
    is_classifier: bool,
    shift: np.ndarray,
    scale: np.ndarray,
    select: dict,
    mode: str,
) -> dict[str, np.ndarray]:
    """The separator and the frequencies as NumPy float64: ``A`` (d × bins·d), ``Z``
    (bins·d × D), and what A was made of: each bin's ``edge_gram`` (the d × d Gram of its
    edge differences), its eigenvalues ``eig`` in decreasing order, the columns it ``keep``s
    and the factor ``lam``. ``select`` holds the ``shift``, ``scale`` and ``mode`` of the
    edge search; ``shift`` and ``scale`` give the edges' values, in ``mode``'s arithmetic."""
    device = codes.device
    d = X_host.shape[1]
    draws = draw(setting["seed"], d=d, num_bins=num_bins, setting=setting, is_classifier=is_classifier,
                 dtype=torch.from_numpy(X_host[:1]).dtype, device=device)
    edges = edge_rows(X_host, codes, num_bins, draws, select)
    with arithmetic(mode) as dtype:
        tiny = torch.finfo(dtype).tiny
        shift_t = torch.as_tensor(np.asarray(shift), device=device).to(dtype).reshape(-1)
        scale_t = torch.as_tensor(np.asarray(scale), device=device).to(dtype).reshape(-1)
        totals = totals.to(device, dtype)
        valid = totals > 0
        degenerate = valid.sum() < 2

        def standardised(idx: torch.Tensor) -> torch.Tensor:
            return (torch.from_numpy(X_host[idx.cpu().numpy()]).to(device, dtype) - shift_t) / scale_t

        edges_in = [standardised(i_in) for i_in, _ in edges]
        edges_out = [standardised(i_out) for _, i_out in edges]
        ess = edges_in[0].shape[0]
        # The leading right singular vectors of each bin's edge differences, from the d×d
        # Gram; a direction under the rank threshold, or of an empty bin, is zeroed.
        Ediff = torch.stack(edges_in) - torch.stack(edges_out)
        edge_gram = Ediff.mT @ Ediff
        e, V = torch.linalg.eigh(edge_gram)
        s = torch.sqrt(e.abs()).flip(-1)
        V = V.flip(-1)
        keep = ((s > setting["rank_threshold"] * s[:, :1]) & valid[:, None]).to(dtype)
        A = (V * keep[:, None, :]).permute(1, 0, 2).reshape(d, num_bins * d)
        # λ = √(2·log(f/g)/(f − g)) of the mass-weighted mean inter- (f) and intra-bin (g)
        # squared edge distances in the separator's space.
        inter = torch.zeros((), dtype=dtype, device=device)
        intra = torch.zeros((), dtype=dtype, device=device)
        for b_idx in range(num_bins):
            p_in, p_out = edges_in[b_idx] @ A, edges_out[b_idx] @ A
            inter = inter + totals[b_idx] * torch.tril(_sq_dists(p_in, p_out)).sum() / (ess * (ess + 1) / 2)
            intra = intra + totals[b_idx] * torch.tril(_sq_dists(p_in, p_in), diagonal=-1).sum() / (ess * (ess - 1) / 2)
        inter, intra = inter / totals.sum(), intra / totals.sum()
        gap = inter - intra
        ratio = torch.where(
            gap.abs() > 1e3 * tiny,
            2.0 * torch.log(inter.clamp_min(tiny) / intra.clamp_min(tiny)) / gap,
            2.0 / intra.clamp_min(tiny),
        )
        lam = torch.where(intra > 0, torch.sqrt(ratio.clamp_min(0.0)), torch.ones_like(ratio))
        identity = torch.eye(d, num_bins * d, dtype=dtype, device=device)
        A = torch.where(degenerate, identity, A * lam)
        # Orthogonal random features: QR in blocks of bins·d columns, each column scaled
        # by a χ variate of as many degrees of freedom as A keeps columns.
        width, D = num_bins * d, setting["num_features"]
        Z = draws["Z"].to(dtype)
        Z = torch.cat([torch.linalg.qr(Z[:, j : j + width])[0] for j in range(0, D, width)], dim=1)
        chi_df = torch.where(degenerate, torch.tensor(float(d), dtype=dtype, device=device), keep.sum()).clamp_min(1.0)
        counted = torch.arange(width, dtype=dtype, device=device)[:, None] < chi_df
        normals = draws["chi_normals"].to(dtype)
        Z = Z * torch.sqrt((normals * normals * counted).sum(dim=0, keepdim=True))
        out = {"A": A, "Z": Z, "edge_gram": edge_gram, "eig": e.flip(-1), "keep": keep, "lam": lam}
        return {k: v.double().cpu().numpy() for k, v in out.items()}


def separator_error(A: np.ndarray, ref: dict) -> float:
    """How far a candidate's separator A is from one made of the reference's edges, free of
    the eigenvectors' signs and of any turn within a nearly repeated eigenvalue: each kept
    column, over its norm, as an eigenvector of its bin's edge Gram (the residual, and its
    Rayleigh quotient off the eigenvalue of its rank, over the bin's largest eigenvalue);
    the columns' norm off λ, relative; and a column kept on one side only counts 1."""
    d = ref["edge_gram"].shape[1]
    worst = 0.0
    norms = np.linalg.norm(A, axis=0)
    lam = float(ref["lam"])
    for b_idx, (G, eig, keep) in enumerate(zip(ref["edge_gram"], ref["eig"], ref["keep"], strict=True)):
        top = float(eig[0])
        for j in range(d):
            norm = norms[b_idx * d + j]
            if (norm > 0.5 * lam) != bool(keep[j]):
                return 1.0
            if not keep[j]:
                continue
            v = A[:, b_idx * d + j] / norm
            mu = float(v @ G @ v)
            worst = max(worst, float(np.linalg.norm(G @ v - mu * v)) / top, abs(mu - float(eig[j])) / top,
                        abs(norm - lam) / lam)
    return worst


def columns_up_to_sign(candidate: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """The sign per column that brings the reference's columns nearest the candidate's (a
    QR column's sign is free)."""
    plus = np.linalg.norm(candidate - reference, axis=0)
    minus = np.linalg.norm(candidate + reference, axis=0)
    return np.where(minus < plus, -1.0, 1.0)
