"""Multi-GPU fits: rows sharded over the ``data`` axis of a ("data", "feature") mesh.

PyTorch port of ``neo_ls_svm_tpu.parallel.mesh``. The JAX package runs one process over
many devices and lets GSPMD (the in-memory fit) or ``shard_map`` (the streaming fit)
place its collectives. Here one process drives one GPU (``torchrun``), every process runs
the same code on its own rows, and every sum across ranks is an explicit call of
``parallel/collectives.py`` on the mesh's process groups:

* rows of X (hence of the feature matrix W) are split into ``num_data`` contiguous blocks,
  the blocks JAX's ``PartitionSpec("data")`` gives its shards; each rank stages only its
  own block, and the ranks of one ``feature`` group hold the same block;
* the weight total, the (2M+1)² augmented Gram, the γ-grid objective and the LOO score's
  moments are summed over ``data``;
* the 2M×2M eigh, γ selection and Cholesky re-solve are repeated on every rank;
* per-row outputs (LOO residuals, leverage, std) come back whole on every rank.

The streaming fit runs K1 (``fused_augmented_gram``) and K2 (``fused_loo_sweep``) on each
rank's rows, as the single-GPU streaming fit does on all of them. With ``num_feature > 1``
it splits the three O(n·(2M)²) contractions over the ``feature`` axis instead, in plain
torch: each rank owns a block of Gram or eigenvector columns, the Gram's column blocks are
gathered before the eigh, and passes 2 and 3 are ``sweep_plain`` and ``pass3_plain`` on
the rank's columns, their num/lev and num/σ² partials summed over ``feature`` before the
nonlinear LOO step (the fused kernels hide those partials).

Every rank passes the full X (a host array, or a tensor on its own device) and receives
the full result: this is the contract of the JAX package's multi-process fit.

The device pre-transform runs on the same row blocks (``sharded_device_pre_transform``):
each rank stages its block of X once, holds y and w whole, and completes every sum over
X's rows over ``data``; its random inputs are drawn once, on the first rank, and sent to
every rank. The solver then takes the staged block as it is.

The fits run their float32 products in IEEE float32 whatever the caller set, and
``sweep_precision="fast"`` runs the γ-sweep's products only in one TF32 pass, as in
``models/primal.py`` (``utils/precision.py``).
"""

import math
from functools import partial
from typing import Any, Literal

import numpy as np
import numpy.typing as npt
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from neo_ls_svm_torch.models.primal import (
    PER_ROW_KEYS,
    eigenbasis,
    embed_from_gram_blocks,
    primal_fit,
    primal_fit_streaming,
    resolve_beta,
    statistics_at_optimum,
)
from neo_ls_svm_torch.ops.cuda.pass3 import pass3_plain
from neo_ls_svm_torch.ops.cuda.sweep import sweep_plain
from neo_ls_svm_torch.ops.loo import features_real_pair, inv_sqrt_width
from neo_ls_svm_torch.ops.pretransform_device import (
    device_pre_transform,
    draw_pretransform_inputs,
    draw_shapes,
)
from neo_ls_svm_torch.parallel import collectives
from neo_ls_svm_torch.utils.device import padded, require_device, to_device
from neo_ls_svm_torch.utils.precision import check_sweep_precision, matmul_precision

AXES = ("data", "feature")

Operand = npt.NDArray | torch.Tensor  # a host array, or a tensor on the rank's device

# The meshes of the current process group, by shape and device type. Every
# init_device_mesh call makes new process groups (NCCL communicators and their device
# buffers) that are never released, so a refit must not build its mesh again.
_MESHES: dict[tuple[Any, int, int, str], DeviceMesh] = {}


def make_mesh(num_data: int | None = None, num_feature: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "feature") mesh over every rank of the initialised process group.

    Rank r sits at data index r // num_feature and feature index r % num_feature (row
    major), so the ranks of one ``feature`` group are neighbours, as on one host. The
    mesh's ``device_type`` names the device each rank computes on: its current CUDA
    device, or the CPU when the caller asks for ``"cpu"``. A mesh is built once per
    process group, shape and device type, and returned again on later calls.
    """
    if not dist.is_available() or not dist.is_initialized():
        msg = (
            "make_mesh needs an initialised process group: call "
            "neo_ls_svm_torch.parallel.distributed.initialize_distributed (or "
            "torch.distributed.init_process_group) first."
        )
        raise RuntimeError(msg)
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_feature
    if num_data < 1 or num_feature < 1 or num_data * num_feature != world:
        msg = f"a ({num_data}, {num_feature}) mesh must hold the world's {world} ranks exactly."
        raise ValueError(msg)
    if device_type == "cuda" and not torch.cuda.is_available():
        msg = "make_mesh(device_type='cuda') needs a CUDA device; pass device_type='cpu' for the CPU."
        raise RuntimeError(msg)
    world_group = dist.group.WORLD
    for stale in [key for key in _MESHES if key[0] is not world_group]:
        del _MESHES[stale]  # built on a process group that has since been destroyed
    key = (world_group, num_data, num_feature, device_type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, (num_data, num_feature), mesh_dim_names=AXES)
    return _MESHES[key]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def required_padding(n: int, num_data: int) -> int:
    """Rows of zero-weight padding needed to align ``n`` to the data axis."""
    return (math.ceil(n / num_data) * num_data) - n


def streaming_row_chunk(n: int, num_data: int, row_chunk: int = 16384) -> int:
    """The per-rank chunk the sharded streaming fit will actually use (its rows are
    padded to ``num_data * streaming_row_chunk(...)``)."""
    return min(row_chunk, math.ceil(n / num_data))


def _block(mesh: DeviceMesh, n: int, mult: int) -> slice:
    """The rows of this rank's block once n rows are padded to a multiple of ``mult``: the
    block at this rank's data index."""
    per = -(-n // mult) * mult // axis_size(mesh, "data")
    lo = mesh.get_local_rank("data") * per
    return slice(lo, lo + per)


def _stage_rows(mesh: DeviceMesh, arr: Operand, mult: int, device: torch.device) -> torch.Tensor:
    """This rank's block of ``arr``'s rows, zero-padded as if ``arr`` were first padded to
    a multiple of ``mult``. A host array crosses to the device block by block; a tensor
    (on ``device``) is sliced and padded there."""
    n = arr.shape[0]
    rows = _block(mesh, n, mult)
    lo, per = rows.start, rows.stop - rows.start
    hi = min(rows.stop, n)
    if isinstance(arr, torch.Tensor):
        require_device(arr, device, "X")
        block = arr[lo:hi]
        return padded(block, per - block.shape[0], device).contiguous()
    block = np.asarray(arr[lo:hi])
    return to_device(block, device, pad=per - block.shape[0])


def _stage_replicated(arr: Operand | None, device: torch.device) -> torch.Tensor | None:
    if arr is None:
        return None
    if isinstance(arr, torch.Tensor):
        require_device(arr, device, "operand")
        return arr
    return to_device(np.asarray(arr), device)


def _stage_padded(arr: Operand, mult: int, device: torch.device) -> torch.Tensor:
    """All of ``arr``'s rows on ``device``, zero-padded to a multiple of ``mult``."""
    pad = (-arr.shape[0]) % mult
    if isinstance(arr, torch.Tensor):
        require_device(arr, device, "operand")
        return padded(arr, pad, device)
    return to_device(np.asarray(arr), device, pad=pad)


def _whole_rows(result: dict[str, torch.Tensor], data: Any, n: int) -> dict[str, torch.Tensor]:
    """Each per-row output gathered over the data axis and trimmed to the true rows."""
    return {
        k: (collectives.gather_rows(v, data)[:n] if k in PER_ROW_KEYS else v) for k, v in result.items()
    }


@matmul_precision("ieee")
def sharded_primal_fit(
    mesh: DeviceMesh,
    X: Operand,
    M_map: Operand,
    b_map: Operand,
    y: Operand,
    sample_weight: Operand,
    gammas: Operand,
    C_emb: Operand | None = None,
    *,
    is_classifier: bool,
    gamma_chunk: int = 128,
    num_samples: int | None = None,
    sweep_precision: Literal["high", "fast"] = "high",
) -> dict[str, torch.Tensor]:
    """``primal_fit`` on this rank's rows, its sums over rows completed over ``data``.

    Rows are zero-weight-padded to a multiple of the data axis (padded rows carry s = 0,
    and the c₀ normalisation uses the true row count ``num_samples``, default n). The
    objective every rank takes its argmin of is one ``all_reduce`` result, the same bits
    on every rank, so every rank picks the same γ.
    """
    n = num_samples if num_samples is not None else X.shape[0]
    device = mesh_device(mesh)
    X_l, y_l, s_l = (_stage_rows(mesh, a, axis_size(mesh, "data"), device) for a in (X, y, sample_weight))
    kw = {"is_classifier": is_classifier, "gamma_chunk": gamma_chunk, "sweep_precision": sweep_precision}
    return _fit_block(mesh, X_l, M_map, b_map, y_l, s_l, gammas, C_emb, n=n, **kw)


def _fit_block(
    mesh: DeviceMesh,
    X_l: torch.Tensor,
    M_map: Operand,
    b_map: Operand,
    y_l: torch.Tensor,
    s_l: torch.Tensor,
    gammas: Operand,
    C_emb: Operand | None,
    *,
    n: int,
    is_classifier: bool,
    gamma_chunk: int = 128,
    sweep_precision: Literal["high", "fast"] = "high",
) -> dict[str, torch.Tensor]:
    """:func:`sharded_primal_fit` on this rank's staged block of rows."""
    data = mesh.get_group("data")
    M_d, b_d, g_d, C_d = (_stage_replicated(a, X_l.device) for a in (M_map, b_map, gammas, C_emb))
    result = primal_fit(
        X_l,
        M_d,
        b_d,
        y_l,
        s_l,
        g_d,
        C_d,
        is_classifier=is_classifier,
        gamma_chunk=gamma_chunk,
        num_samples=n,
        row_sum=partial(collectives.sum_over, group=data),
        sweep_precision=sweep_precision,
    )
    return _whole_rows(result, data, n)


@matmul_precision("ieee")
def sharded_primal_fit_streaming(
    mesh: DeviceMesh,
    X: Operand,
    M_map: Operand,
    b_map: Operand,
    y: Operand,
    sample_weight: Operand,
    gammas: Operand,
    C_emb: Operand | None = None,
    *,
    is_classifier: bool,
    row_chunk: int = 16384,
    num_samples: int | None = None,
    sweep_precision: Literal["high", "fast"] = "high",
) -> dict[str, torch.Tensor]:
    """Row-sharded *streaming* primal fit: O(row_chunk·2M) memory per rank.

    Rows are zero-weight-padded to a multiple of ``num_data * row_chunk``. With
    ``num_feature == 1`` each rank runs ``primal_fit_streaming`` on its own rows, its sums
    over rows completed over ``data``: pass 1 is K1 on the rank's rows (``C_emb`` is None;
    a custom C takes ``gram_plain``), pass 2 is K2 on them; on CPU tensors both run their
    plain versions. With ``num_feature > 1`` the three passes run in plain torch on
    column blocks (passes 2 and 3 in ``sweep_plain`` and ``pass3_plain``), with two sums
    over ``feature`` per row chunk in each of passes 2 and 3. The per-row outputs come
    back whole. ``sweep_precision`` reaches K2, or, on the feature axis, pass 2's three
    products (Gu, num and lev; X·M stays IEEE, as in JAX).
    """
    check_sweep_precision(sweep_precision)
    n = num_samples if num_samples is not None else X.shape[0]
    num_data = axis_size(mesh, "data")
    device = mesh_device(mesh)
    row_chunk = streaming_row_chunk(n, num_data, row_chunk)
    X_l, y_l, w_l = (_stage_rows(mesh, a, num_data * row_chunk, device) for a in (X, y, sample_weight))
    kw = {"is_classifier": is_classifier, "sweep_precision": sweep_precision}
    return _fit_streaming_block(mesh, X_l, M_map, b_map, y_l, w_l, gammas, C_emb, n=n, row_chunk=row_chunk, **kw)


def _fit_streaming_block(
    mesh: DeviceMesh,
    X_l: torch.Tensor,
    M_map: Operand,
    b_map: Operand,
    y_l: torch.Tensor,
    w_l: torch.Tensor,
    gammas: Operand,
    C_emb: Operand | None,
    *,
    n: int,
    row_chunk: int,
    is_classifier: bool,
    sweep_precision: Literal["high", "fast"] = "high",
) -> dict[str, torch.Tensor]:
    """:func:`sharded_primal_fit_streaming` on this rank's staged block of rows, a
    multiple of ``row_chunk`` high."""
    data = mesh.get_group("data")
    device = X_l.device
    M_d, b_d, g_d, C_d = (_stage_replicated(a, device) for a in (M_map, b_map, gammas, C_emb))
    row_sum = partial(collectives.sum_over, group=data)
    num_feature = axis_size(mesh, "feature")
    if num_feature == 1:
        result = primal_fit_streaming(
            X_l,
            M_d,
            b_d,
            y_l,
            w_l,
            g_d,
            C_d,
            is_classifier=is_classifier,
            row_chunk=row_chunk,
            num_samples=n,
            row_sum=row_sum,
            sweep_precision=sweep_precision,
        )
        return _whole_rows(result, data, n)

    # The feature axis: each rank contracts every row chunk against its block of Gram or
    # eigenvector columns. One column gather reassembles the Gram before the eigh; passes 2
    # and 3 are the plain versions of K2 and K3 on this rank's columns, their num/lev and
    # num/σ² sums over columns completed over "feature" before the nonlinear LOO step (the
    # fused kernels hide those partials, so neither runs here, as in JAX).
    feature = mesh.get_group("feature")
    f_idx = mesh.get_local_rank("feature")
    feature_sum = partial(collectives.sum_over, group=feature)
    M = M_d.shape[1] + 1
    M2 = 2 * M
    s_l = w_l / row_sum(torch.sum(w_l))
    s2_l = s_l * s_l

    def column_block(a: torch.Tensor, width: int) -> torch.Tensor:
        """This feature rank's block of ``a``'s columns, zero-padded to ``width`` first
        (padded columns contribute exactly nothing to any contraction)."""
        block = width // num_feature
        padded = torch.nn.functional.pad(a, (0, width - a.shape[1]))
        return padded[:, f_idx * block : (f_idx + 1) * block]

    # Pass 1: the row chunk against this rank's block of Y = [W | y]'s columns.
    gram_cols = -(-(M2 + 1) // num_feature) * num_feature
    G_cols = torch.zeros((M2 + 1, gram_cols // num_feature), dtype=X_l.dtype, device=device)
    inv_sqrt_D = inv_sqrt_width(X_l, M_d)
    for start in range(0, X_l.shape[0], row_chunk):
        rows = slice(start, start + row_chunk)
        Y_b = torch.cat([features_real_pair(X_l[rows], M_d, b_d, inv_sqrt_D), y_l[rows, None]], dim=1)
        G_cols += (Y_b.T * s2_l[None, rows]) @ column_block(Y_b, gram_cols)
    G_aug = collectives.gather_columns(row_sum(G_cols), feature)[:, : M2 + 1]
    G, b_vec = G_aug[:M2, :M2], G_aug[:M2, M2]
    B = embed_from_gram_blocks(G, M)
    basis = eigenbasis(B, b_vec, C_d, n)
    eig_cols = -(-M2 // num_feature) * num_feature
    Qs_loc = column_block(basis.Qs, eig_cols)
    k_loc = column_block(basis.k[None, :], eig_cols)[0]
    r_loc = column_block((1.0 / (g_d[None, :] + basis.lam[:, None])).T, eig_cols).T  # block × G
    plain = {"inv_c0": basis.inv_c0, "chunk_rows": row_chunk, "feature_sum": feature_sum}

    # Pass 2: the γ-sweep.
    loo_errors_gs, objective = row_sum(torch.stack(sweep_plain(
        X_l, M_d, b_d, y_l, s_l, s2_l, Qs_loc, r_loc, k_loc, is_classifier=is_classifier, precision=sweep_precision,
        **plain,
    )))
    optimum = torch.argmin(objective)
    gamma_opt = g_d[optimum]
    beta_emb = resolve_beta(B, C_d, b_vec, basis, gamma_opt)

    # Pass 3: per-row statistics at the optimum.
    r_opt = 1.0 / (gamma_opt + basis.lam)
    r_opt_loc, kr_opt_loc = (column_block(v[None, :], eig_cols)[0] for v in (r_opt, basis.k * r_opt))
    num, sigma2, resid = pass3_plain(X_l, M_d, b_d, y_l, Qs_loc, kr_opt_loc, r_opt_loc, basis.sign * beta_emb, **plain)
    result = statistics_at_optimum(
        num, sigma2, resid, y_l, s_l, s2_l, loo_errors_gs, optimum, gamma_opt, basis, beta_emb,
        is_classifier=is_classifier, row_sum=row_sum,
    )
    return _whole_rows(result, data, n)


@matmul_precision("ieee")
def sharded_device_pre_transform(
    mesh: DeviceMesh,
    X_block: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    num_bins: int,
    num_features: int,
    edge_sample_size: int,
    edge_search_multiplier: int,
    rank_threshold: float,
    is_classifier: bool,
    orthogonal: bool = True,
    draws: dict[str, Any] | None = None,
) -> dict[str, torch.Tensor]:
    """``device_pre_transform`` over the row blocks of the ``data`` axis.

    ``X_block`` is this rank's block of rows (``_stage_rows``), and ``y`` and ``w`` are all
    rows, zero-padded as X's blocks are (``len(y)`` is the data axis times the block's
    height), on this rank's device. Every sum over X's rows is completed over ``data``: the
    bin masses and medians' bisection, the neighbouring values, the deviations, and each
    sampled row, which only the rank that holds it fills. The bins, their masses and the
    row draws use y and w alone, so every rank has them whole and alike. The random inputs
    come from ``draws`` where given (the same on every rank), else from ``generator`` on
    the first rank of the world, once, and are sent to every rank, so the mesh draws what
    one GPU with that generator draws. Every rank returns the same operands.
    """
    height, num_data = X_block.shape[0], axis_size(mesh, "data")
    if y.shape[0] != num_data * height or w.shape[0] != y.shape[0]:
        msg = f"y and w must hold the {num_data} blocks of {height} rows: {y.shape[0]} and {w.shape[0]} rows."
        raise ValueError(msg)
    settings = {
        "num_bins": num_bins,
        "num_features": num_features,
        "edge_sample_size": edge_sample_size,
        "edge_search_multiplier": edge_search_multiplier,
        "is_classifier": is_classifier,
        "orthogonal": orthogonal,
    }
    if draws is None:
        shapes = draw_shapes(X_block.shape[1], **settings)
        if dist.get_rank() == 0:
            draws = draw_pretransform_inputs(generator, shapes, X_block.dtype, X_block.device)
        else:
            draws = {k: X_block.new_empty(shape) for k, shape in shapes.items()}
        draws = {k: collectives.broadcast_from_first(v, None) for k, v in draws.items()}
    data = mesh.get_group("data")
    return device_pre_transform(
        X_block,
        y,
        w,
        draws=draws,
        rank_threshold=rank_threshold,
        row_sum=partial(collectives.sum_over, group=data),
        row_gather=partial(collectives.gather_rows, group=data),
        row_start=mesh.get_local_rank("data") * height,
        **settings,
    )


@matmul_precision("ieee")
def sharded_primal_fit_device_pt(
    mesh: DeviceMesh,
    X: Operand,
    y: Operand,
    sample_weight: Operand,
    generator: torch.Generator | None,
    gammas: Operand,
    *,
    is_classifier: bool,
    num_bins: int,
    num_features: int,
    edge_sample_size: int,
    edge_search_multiplier: int,
    rank_threshold: float,
    orthogonal: bool,
    stream: bool,
    row_chunk: int = 16384,
    sweep_precision: Literal["high", "fast"] = "high",
) -> dict[str, torch.Tensor]:
    """Mesh fit with the on-device pre-transform, on each rank's rows.

    Each rank stages its block of X's rows once (the blocks of the fit that follows:
    padded to ``num_data * row_chunk`` rows when streaming, else to ``num_data``) and all
    of y and w, padded alike (padding rows carry weight 0, hence the exclusion code). It
    runs :func:`sharded_device_pre_transform` on them with ``generator``, drawn from on the
    first rank only, exactly as a single-GPU fit with the same seed draws; then the
    sharded solver runs on the same block. Returns the solver result plus ``pt_M``,
    ``pt_b`` and the ``pt_*`` state, as the single-GPU route does, the same on every rank.
    """
    n = X.shape[0]
    num_data = axis_size(mesh, "data")
    device = mesh_device(mesh)
    row_chunk = streaming_row_chunk(n, num_data, row_chunk)
    mult = num_data * row_chunk if stream else num_data
    X_l = _stage_rows(mesh, X, mult, device)
    y_all, w_all = (_stage_padded(a, mult, device) for a in (y, sample_weight))
    pt = sharded_device_pre_transform(
        mesh,
        X_l,
        y_all,
        w_all,
        generator,
        num_bins=num_bins,
        num_features=num_features,
        edge_sample_size=edge_sample_size,
        edge_search_multiplier=edge_search_multiplier,
        rank_threshold=rank_threshold,
        is_classifier=is_classifier,
        orthogonal=orthogonal,
    )
    rows = _block(mesh, n, mult)
    operands = (mesh, X_l, pt["M"], pt["b"], y_all[rows], w_all[rows], gammas, None)
    kw = {"n": n, "is_classifier": is_classifier, "sweep_precision": sweep_precision}
    if stream:
        result = _fit_streaming_block(*operands, row_chunk=row_chunk, **kw)
    else:
        result = _fit_block(*operands, **kw)
    return {**result, "pt_M": pt["M"], "pt_b": pt["b"], **{k: v for k, v in pt.items() if k.startswith("pt_")}}
