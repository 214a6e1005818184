"""K2: the fused leave-one-out γ-sweep and its plain PyTorch version.

``fused_loo_sweep`` evaluates, for every γ of the grid, the weighted LOO error and the
γ-selection objective of the streaming solver's second pass. On a CUDA tensor it launches
the hand-written kernels that port ``neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep``:
in float32 ``csrc/sweep.cu`` on the TMA + wgmma 3×TF32 product loop of
``csrc/gemm_sm90.cuh``, or under ``precision="fast"`` ``csrc/sweep_1xtf32.cu`` on the
persistent one-pass loop of ``csrc/gemm_sm90_1xtf32.cuh``; in float64 ``csrc/sweep_fp64.cu``
on the TMA + DMMA product loop of ``csrc/gemm_sm90_f64.cuh`` (the FP64 tensor cores). On a
CPU tensor it runs :func:`sweep_plain`. There is no fallback from one to the other.

``precision`` mirrors the Pallas kernel's ``mxu_precision``: ``"high"`` (HIGHEST) runs
float32 in 3×TF32, ``"fast"`` (DEFAULT) in one TF32 pass, each counted under its own path.
Float64 has no TF32 and runs its one kernel under either, as JAX's DEFAULT is exact in
float64 off the TPU.
"""

import math
from collections.abc import Callable
from typing import Literal

import torch

from neo_ls_svm_torch.ops.cuda._build import (
    PATH_FP64,
    PATH_TF32,
    PATH_TF32_1,
    check_operands,
    check_status,
    load_library,
)
from neo_ls_svm_torch.ops.loo import clip_classifier_residuals, features_real_pair, identity
from neo_ls_svm_torch.ops.loo import inv_sqrt_width, sweep_objective
from neo_ls_svm_torch.utils.precision import SWEEP_MATMUL, check_sweep_precision, matmul_precision

launches = 0  # Kernel launches of fused_loo_sweep (its plain version is not counted).
path_launches = {PATH_TF32: 0, PATH_TF32_1: 0, PATH_FP64: 0}  # the same launches, by kernel path
# TF32 passes of each float32 product, by precision.
_PASSES = {"high": 3, "fast": 1}

_TILE = 128  # kBM = kBN in csrc/gemm_sm90.cuh; kBM and the Gu tile's kBNGu in csrc/sweep_fp64.cu
_KBLOCK = 32  # kBK in csrc/gemm_sm90.cuh and csrc/gemm_sm90_1xtf32.cuh
# The one-pass loop (csrc/gemm_sm90_1xtf32.cuh, csrc/sweep_1xtf32.cu): kBN, the columns of a
# Gu tile and the values of γ of a sweep tile; kRowsGu, the rows of a Gu tile (a sweep tile
# has half).
_TILE_1X, _ROWS_1X = 176, 256
_KBLOCK_F64 = 16  # kBK in csrc/gemm_sm90_f64.cuh
_GAMMA_TILE_F64 = 64  # kBNLoo in csrc/sweep_fp64.cu: values of γ per sweep tile
# Rows per chunk, in either dtype. The Gu and sweep products then launch 1152 and 1024
# blocks a chunk in float32 (2M = 1026, G = 1024: 8.7 and 7.8 waves of the H100's 132 SMs),
# 1152 and 2048 in float64.
_CHUNK_ROWS = 16384
# The one-pass kernels' chunk: their blocks are persistent, so a chunk costs one start and
# one tail of each; twice as many rows a chunk ran faster on the card (PERF.md §6).
_CHUNK_ROWS_1X = 32768


def sweep_plan(
    n: int, D: int, G: int, precision: Literal["high", "fast"] = "high", dtype: torch.dtype = torch.float32
) -> dict[str, int]:
    """The kernels' row chunk and workspace for n rows, D features and G values of γ.

    The workspace holds the chunk's W and Gu∘k, Gu∘Gu, Qsᵀ and r_allᵀ, in float32 in their
    TF32 planes (hi and lo under "high", hi alone under "fast"), in float64 in one plane
    under either, and the chunk's row-tile partials: it is bounded by the chunk, not by n,
    and any D fits. Under "fast" the plan also gives the one-pass kernels' tiles: ``tile``
    columns of Gu (``col_tiles`` of them) and values of γ (``gamma_tiles``) a tile,
    ``row_tile`` rows of a Gu tile.
    """
    M2 = 2 * D + 2
    Np = -(-M2 // _TILE) * _TILE
    if dtype == torch.float32 and _PASSES[precision] == 1:
        return _one_pass_plan(n, M2, G)
    chunk = min(_CHUNK_ROWS, -(-max(n, 1) // _TILE) * _TILE)
    if dtype == torch.float64:
        Kp = -(-M2 // _KBLOCK_F64) * _KBLOCK_F64
        Gp = -(-G // _GAMMA_TILE_F64) * _GAMMA_TILE_F64
        elements = 3 * chunk * Kp + Np * Kp + Gp * Kp + 2 * (chunk // _TILE) * Gp
        return {"chunk": chunk, "workspace_bytes": 8 * elements}
    Kp = -(-M2 // _KBLOCK) * _KBLOCK
    Gp = -(-G // _TILE) * _TILE
    floats = 2 * (3 * chunk * Kp + Np * Kp + Gp * Kp) + 2 * (chunk // _TILE) * Gp
    return {"chunk": chunk, "workspace_bytes": 4 * floats}


def _one_pass_plan(n: int, M2: int, G: int) -> dict[str, int]:
    """``csrc/sweep_1xtf32.cu``'s chunk (a multiple of the Gu tile's rows), tiles and
    workspace: W (its TF32 plane) and Gu (float32) of the chunk, Qsᵀ and r_allᵀ padded to
    whole tiles, k padded to Kp, and the partials of the chunk's 128-row sweep tiles."""
    chunk = min(_CHUNK_ROWS_1X, -(-max(n, 1) // _ROWS_1X) * _ROWS_1X)
    Kp = -(-M2 // _KBLOCK) * _KBLOCK
    col_tiles = -(-Kp // _TILE_1X)
    Nq = -(-(col_tiles * _TILE_1X) // _KBLOCK) * _KBLOCK
    gamma_tiles = -(-G // _TILE_1X)
    Gq = gamma_tiles * _TILE_1X
    Gr = -(-Gq // _KBLOCK) * _KBLOCK
    floats = 2 * chunk * Kp + Nq * Kp + Gr * Kp + Kp + 2 * (chunk // (_ROWS_1X // 2)) * Gq
    return {
        "chunk": chunk,
        "workspace_bytes": 4 * floats,
        "tile": _TILE_1X,
        "row_tile": _ROWS_1X,
        "col_tiles": col_tiles,
        "gamma_tiles": gamma_tiles,
    }


@matmul_precision("ieee")
def sweep_plain(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    s: torch.Tensor,
    s2: torch.Tensor,
    Qs: torch.Tensor,
    r_all: torch.Tensor,
    k: torch.Tensor,
    *,
    is_classifier: bool,
    inv_c0: "torch.Tensor | float",
    chunk_rows: int = 16384,
    precision: Literal["high", "fast"] = "high",
    feature_sum: Callable[[torch.Tensor], torch.Tensor] = identity,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the JAX package's eager sweep
    (``models/primal.py`` streaming pass 2), summed over row chunks.

    U = X·M + b runs in IEEE float32 under either precision, as in the kernel; Gu, num
    and lev run in IEEE under "high" and in one TF32 pass under "fast" (on a CUDA tensor:
    on the CPU every product is IEEE).

    ``feature_sum`` completes num and lev, right after their contraction, over the
    columns of Qs, k and r_all held elsewhere: the identity here, and a sum across ranks
    when each holds a block of those columns (``parallel/mesh.py``'s feature axis)."""
    check_sweep_precision(precision)
    G = r_all.shape[1]
    loo_err = torch.zeros(G, dtype=X.dtype, device=X.device)
    objective = torch.zeros(G, dtype=X.dtype, device=X.device)
    inv_sqrt_D = inv_sqrt_width(X, M_map)
    for start in range(0, X.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        W = features_real_pair(X[rows], M_map, b_map, inv_sqrt_D)
        with matmul_precision(SWEEP_MATMUL[precision]):
            Gu = W @ Qs
            num = inv_c0 * ((Gu * k[None, :]) @ r_all)
            lev = inv_c0 * s2[rows, None] * ((Gu * Gu) @ r_all)
        num, lev = feature_sum(num), feature_sum(lev)
        e = clip_classifier_residuals((num - y[rows, None]) / (1.0 - lev), y[rows], is_classifier)
        err_b, obj_b = sweep_objective(e, s[rows], is_classifier)
        loo_err += err_b
        objective += obj_b
    return loo_err, objective


def fused_loo_sweep(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    s: torch.Tensor,
    s2: torch.Tensor,
    Qs: torch.Tensor,
    r_all: torch.Tensor,
    k: torch.Tensor,
    *,
    is_classifier: bool,
    inv_c0: float,
    precision: Literal["high", "fast"] = "high",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (loo_errors, objective), each of shape (G,), summed over all rows.

    ``Qs`` is the sign-folded (2M, 2M) eigenbasis, ``r_all`` the (2M, G) resolvent
    columns 1/(γ+λ), ``k`` = Qsᵀ·WᵀS²y, and ``inv_c0`` the resolvent scale 1/c₀.
    A CUDA tensor launches the kernel (or raises); a CPU tensor runs :func:`sweep_plain`,
    in IEEE under either ``precision``.
    """
    check_sweep_precision(precision)
    if X.device.type == "cpu":
        return sweep_plain(
            X, M_map, b_map, y, s, s2, Qs, r_all, k, is_classifier=is_classifier, inv_c0=inv_c0,
            precision=precision,
        )
    b_vec = b_map.reshape(-1)
    check_operands(X, M_map=M_map, b_map=b_vec, y=y, s=s, s2=s2, Qs=Qs, r_all=r_all, k=k)
    n, d = X.shape
    D = M_map.shape[1]
    M2 = 2 * D + 2
    G = r_all.shape[1]
    if (
        M_map.shape != (d, D)
        or b_vec.shape != (D,)
        or Qs.shape != (M2, M2)
        or r_all.shape != (M2, G)
        or k.shape != (M2,)
        or not (y.shape == s.shape == s2.shape == (n,))
    ):
        msg = (
            f"shape mismatch: X {tuple(X.shape)}, M {tuple(M_map.shape)}, Qs {tuple(Qs.shape)}, "
            f"r_all {tuple(r_all.shape)}, k {tuple(k.shape)}, y/s/s2 "
            f"{tuple(y.shape)}/{tuple(s.shape)}/{tuple(s2.shape)}"
        )
        raise ValueError(msg)
    lib = load_library()
    loo_err = torch.empty(G, dtype=X.dtype, device=X.device)
    objective = torch.empty(G, dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    inv_sqrt_d = 1.0 / math.sqrt(D)
    plan = sweep_plan(n, D, G, precision, X.dtype)
    workspace = torch.empty(plan["workspace_bytes"] // X.element_size(), dtype=X.dtype, device=X.device)
    operands = (Qs.data_ptr(), r_all.data_ptr(), k.data_ptr(), loo_err.data_ptr(), objective.data_ptr())
    args = (*operands, workspace.data_ptr(), n, d, D, G, plan["chunk"], int(is_classifier))
    if X.dtype == torch.float32:
        args += (_PASSES[precision],)
        entry = lib.neo_sweep_f32
        path = PATH_TF32 if precision == "high" else PATH_TF32_1
    else:
        entry = lib.neo_sweep_f64
        path = PATH_FP64
    with torch.cuda.device(X.device):
        status = entry(
            X.data_ptr(),
            M_map.data_ptr(),
            b_vec.data_ptr(),
            y.data_ptr(),
            s.data_ptr(),
            s2.data_ptr(),
            *args,
            inv_sqrt_d,
            float(inv_c0),
            stream,
        )
    check_status(lib, status, "fused_loo_sweep")
    global launches
    launches += 1
    path_launches[path] += 1
    return loo_err, objective
