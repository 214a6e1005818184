"""K1: the fused feature build + augmented Gram, its plain PyTorch version, and the
re-indexing into the solver's W basis.

``fused_augmented_gram`` computes G = Yᵀ·diag(s²)·Y for Y = [cos U/√D | sin U/√D | 1 | y],
U = X·M + b: every second-order statistic of the streaming solver's first pass. On a CUDA
tensor it launches the hand-written kernels that port
``neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram``: features built once per row
chunk, then in float32 the TMA + wgmma 3×TF32 product loop of ``csrc/gemm_sm90.cuh``
(``csrc/gram.cu``), in float64 the TMA + DMMA product loop of ``csrc/gemm_sm90_f64.cuh`` on
the FP64 tensor cores (``csrc/gram_fp64.cu``). On a CPU tensor it runs :func:`gram_plain`.
There is no fallback from one to the other.
"""

import math

import torch

from neo_ls_svm_torch.ops.cuda._build import PATH_FP64, PATH_TF32, check_operands, check_status, load_library
from neo_ls_svm_torch.ops.loo import fourier_pair, inv_sqrt_width
from neo_ls_svm_torch.utils.precision import matmul_precision

launches = 0  # Kernel launches of fused_augmented_gram (its plain version is not counted).
path_launches = {PATH_TF32: 0, PATH_FP64: 0}  # the same launches, by kernel path

_TILE = 128  # kBM = kBN in csrc/gemm_sm90.cuh and csrc/gemm_sm90_f64.cuh
# Rows per k-block of the product: kBK in csrc/gemm_sm90.cuh (32 f32) and
# csrc/gemm_sm90_f64.cuh (16 f64), one 128-byte swizzle row either way.
_KBLOCK = {torch.float32: 32, torch.float64: 16}
# Rows per chunk, the streaming route's own row_chunk. Its sYᵀ is 151 MB at D = 512 in
# either dtype (f32 hi and lo, or one f64 plane); the blocks in flight read about 3 of its
# 8 splits (57 MB), near the 50 MB L2. On an H100, halving the chunk (and with it each
# block's run of rows) was slower in f32 even though its features then fit in L2.
_CHUNK_ROWS = 16384
# Row splits per chunk. 45 upper tiles (D = 512) × 8 = 360 blocks, 2.7 waves of the H100's
# 132 SMs at one block per SM; 4 and 12 splits were slower in f32 on an H100.
_SPLITS = 8


def gram_plan(n: int, D: int, dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """The kernel's row chunk, row split and workspace for n rows and D features.

    The workspace is the chunk's sYᵀ (F = 2D+2 rounded up to a tile; f32 in its TF32 hi and
    lo planes, f64 in one plane) and one partial of the upper-triangle tiles per split: it
    is bounded by the chunk, not by n. A chunk is whole 32-row feature tiles.
    """
    F = -(-(2 * D + 2) // _TILE) * _TILE
    nt = F // _TILE
    kblock = _KBLOCK[dtype]
    chunk = min(_CHUNK_ROWS, -(-max(n, 1) // 32) * 32)
    kblocks = chunk // kblock
    kb_per_split = -(-kblocks // min(_SPLITS, kblocks))
    splits = -(-kblocks // kb_per_split)
    planes = 2 if dtype == torch.float32 else 1
    elements = planes * F * chunk + splits * nt * (nt + 1) // 2 * _TILE * _TILE
    itemsize = 4 if dtype == torch.float32 else 8
    return {"chunk": chunk, "splits": splits, "kb_per_split": kb_per_split, "workspace_bytes": itemsize * elements}


@matmul_precision("ieee")
def gram_plain(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    s2: torch.Tensor,
    y: torch.Tensor,
    *,
    chunk_rows: int = 65536,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the same [cos | sin | 1 | y] order.

    Mirrors ``augmented_gram_reference`` of the JAX package, summed over row chunks so
    its memory stays O(chunk_rows·(2D+2)). Its products are IEEE float32 (HIGHEST), as
    every dot of the Pallas kernel.
    """
    K = 2 * M_map.shape[1] + 2
    G = torch.zeros((K, K), dtype=X.dtype, device=X.device)
    inv_sqrt_D = inv_sqrt_width(X, M_map)
    for start in range(0, X.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        cos_u, sin_u = fourier_pair(X[rows], M_map, b_map, inv_sqrt_D)
        ones = torch.ones((cos_u.shape[0], 1), dtype=X.dtype, device=X.device)
        Y = torch.cat([cos_u, sin_u, ones, y[rows, None]], dim=1)
        G += (Y.T * s2[None, rows]) @ Y
    return G


def w_basis_from_augmented(G_aug: torch.Tensor, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Map the kernel's [cos|sin|1|y] augmented Gram into W-basis (Gram, rhs).

    W's column order is [cos/√D, 1, sin/√D, 0] (see ``ops/loo.py``); the trailing
    zero column contributes zero rows/cols.
    """
    M = D + 1
    device = G_aug.device
    idx = torch.cat(
        [
            torch.arange(D, device=device),
            torch.tensor([2 * D], device=device),
            torch.arange(D, 2 * D, device=device),
        ]
    )
    G_W = torch.zeros((2 * M, 2 * M), dtype=G_aug.dtype, device=device)
    G_W[: 2 * M - 1, : 2 * M - 1] = G_aug[idx[:, None], idx[None, :]]
    b_vec = torch.zeros(2 * M, dtype=G_aug.dtype, device=device)
    b_vec[: 2 * M - 1] = G_aug[idx, 2 * D + 1]
    return G_W, b_vec


def fused_augmented_gram(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    s2: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """G = Yᵀ·diag(s²)·Y, Y = [cos(XM+b)/√D | sin(XM+b)/√D | 1 | y], as a (2D+2)² tensor.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs :func:`gram_plain`.
    """
    if X.device.type == "cpu":
        return gram_plain(X, M_map, b_map, s2, y)
    b_vec = b_map.reshape(-1)
    check_operands(X, M_map=M_map, b_map=b_vec, s2=s2, y=y)
    n, d = X.shape
    D = M_map.shape[1]
    if M_map.shape != (d, D) or b_vec.shape != (D,) or s2.shape != (n,) or y.shape != (n,):
        msg = (
            f"shape mismatch: X {tuple(X.shape)}, M {tuple(M_map.shape)}, b {tuple(b_map.shape)}, "
            f"s2 {tuple(s2.shape)}, y {tuple(y.shape)}"
        )
        raise ValueError(msg)
    lib = load_library()
    K = 2 * D + 2
    G = torch.empty((K, K), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    plan = gram_plan(n, D, X.dtype)
    workspace = torch.empty(plan["workspace_bytes"] // X.element_size(), dtype=X.dtype, device=X.device)
    args = (n, d, D, plan["chunk"], plan["splits"], plan["kb_per_split"], 1.0 / math.sqrt(D), stream)
    entry = lib.neo_gram_f32 if X.dtype == torch.float32 else lib.neo_gram_f64
    with torch.cuda.device(X.device):
        status = entry(
            X.data_ptr(),
            M_map.data_ptr(),
            b_vec.data_ptr(),
            s2.data_ptr(),
            y.data_ptr(),
            G.data_ptr(),
            workspace.data_ptr(),
            *args,
        )
    check_status(lib, status, "fused_augmented_gram")
    global launches
    launches += 1
    path_launches[PATH_TF32 if X.dtype == torch.float32 else PATH_FP64] += 1
    return G
