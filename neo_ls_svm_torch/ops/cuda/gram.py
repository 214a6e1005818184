"""K1: the fused feature build + augmented Gram, its plain PyTorch version, and the
re-indexing into the solver's W basis.

``fused_augmented_gram`` computes G = Yᵀ·diag(s²)·Y for Y = [cos U/√D | sin U/√D | 1 | y],
U = X·M + b: every second-order statistic of the streaming solver's first pass. On a CUDA
tensor it launches the hand-written kernel of ``csrc/gram.cu`` (the port of
``neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram``); on a CPU tensor it runs
:func:`gram_plain`. There is no fallback from one to the other.
"""

import math

import torch

from neo_ls_svm_torch.ops.cuda._build import check_operands, check_status, load_library

launches = 0  # Kernel launches of fused_augmented_gram (its plain version is not counted).

_TILE = 128  # kTile in csrc/gram.cu: output tile edge in internal columns.
_ROWS = 16  # kRows in csrc/gram.cu: rows per staged chunk.
_BLOCKS_PER_SM_TARGET = 6  # blocks per SM the row split aims at: ~6 waves of the one
# block per SM that fits (the f32 kernel uses 239 registers a thread)


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
    its memory stays O(chunk_rows·(2D+2)).
    """
    D = M_map.shape[1]
    K = 2 * D + 2
    inv_sqrt_D = 1.0 / torch.sqrt(torch.tensor(D, dtype=X.dtype, device=X.device))
    G = torch.zeros((K, K), dtype=X.dtype, device=X.device)
    for start in range(0, X.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        U = X[rows] @ M_map + b_map.reshape(1, -1)
        Y = torch.cat(
            [
                torch.cos(U) * inv_sqrt_D,
                torch.sin(U) * inv_sqrt_D,
                torch.ones((U.shape[0], 1), dtype=X.dtype, device=X.device),
                y[rows, None],
            ],
            dim=1,
        )
        G += (Y.T * s2[None, rows]) @ Y
    return G


def w_basis_from_augmented(G_aug: torch.Tensor, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Map the kernel's [cos|sin|1|y] augmented Gram into W-basis (Gram, rhs).

    W's column order is [cos/√D, 1, sin/√D, 0] (see ``models/primal.py``); the trailing
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
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    nt = -(-2 * D // _TILE)
    ntiles = nt * (nt + 1) // 2
    splits = max(1, min(-(-n // _ROWS), -(-_BLOCKS_PER_SM_TARGET * sms // ntiles)))
    rows_per_split = -(-(-(-n // splits)) // _ROWS) * _ROWS
    splits = -(-n // rows_per_split)
    K = 2 * D + 2
    G = torch.empty((K, K), dtype=X.dtype, device=X.device)
    workspace = torch.empty(lib.neo_gram_workspace(D, splits), dtype=X.dtype, device=X.device)
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
            n,
            d,
            D,
            splits,
            rows_per_split,
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    check_status(lib, status, "fused_augmented_gram")
    global launches
    launches += 1
    return G
