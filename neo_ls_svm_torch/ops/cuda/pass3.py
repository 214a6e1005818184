"""K3: the streaming solver's third pass at the chosen γ, and its plain PyTorch version.

For every row i of X, at the resolvent column r = 1/(γ + λ) of the chosen γ,

    W_i = [cos U_i/√D, 1, sin U_i/√D, 0],  U_i = x_i·M + b,  Gu_i = W_i·Qs,
    num_i = inv_c0·Gu_i·(k∘r),  σ²_i = inv_c0·(Gu_i∘Gu_i)·r,  res_i = W_i·β − y_i,

the three n-vectors from which ``models/primal.py::primal_fit_streaming`` forms the LOO
residuals, the leverage, the LOO variance and the training residuals (β = sign∘β_emb).

``fused_pass3`` launches ``csrc/pass3.cu``: the chunk's features built once, Gu on the TMA +
wgmma 3×TF32 product loop of ``csrc/gemm_sm90.cuh`` against [Qs | β]ᵀ, and Gu reduced to the
three statistics in the product's epilogue. It replaces no Pallas kernel (the JAX package
runs this pass as XLA operations); it was added because the pass's IEEE float32 product on
the CUDA cores was the largest single cost of a large float32 streaming fit on an H100. It
takes float32 CUDA tensors only, and raises on anything else. :func:`pass3_plain` is the
pass as PyTorch operations, row chunk by row chunk: the solver runs it on CPU tensors and on
float64 rows, and the tests hold the kernel against it.
"""

import math

import torch

from neo_ls_svm_torch.ops.cuda._build import PATH_TF32, check_status, load_library
from neo_ls_svm_torch.utils.precision import matmul_precision

launches = 0  # Kernel launches of fused_pass3 (its plain version is not counted).
path_launches = {PATH_TF32: 0}  # the same launches, by kernel path

_TILE = 128  # kBM = kBN in csrc/gemm_sm90.cuh
_KBLOCK = 32  # kBK in csrc/gemm_sm90.cuh
# Rows per chunk, as K2's: W's two TF32 planes are 138 MB at D = 512, and the product
# launches 128 × 9 blocks a chunk (8.7 waves of the H100's 132 SMs).
_CHUNK_ROWS = 16384


def pass3_plan(n: int, D: int) -> dict[str, int]:
    """The kernel's row chunk, column tiles and workspace for n rows and D features.

    The workspace holds the chunk's W and [Qs | β]ᵀ in their TF32 hi and lo planes (k padded
    to 32, the 2M + 1 columns to whole 128-column tiles) and the column tiles' per-row
    partials of the chunk: it is bounded by the chunk, not by n.
    """
    M2 = 2 * D + 2
    Kp = -(-M2 // _KBLOCK) * _KBLOCK
    col_tiles = -(-(M2 + 1) // _TILE)
    chunk = min(_CHUNK_ROWS, -(-max(n, 1) // _TILE) * _TILE)
    floats = 2 * chunk * Kp + 2 * col_tiles * _TILE * Kp + 2 * col_tiles * chunk
    return {"chunk": chunk, "col_tiles": col_tiles, "workspace_bytes": 4 * floats}


@matmul_precision("ieee")
def pass3_plain(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    Qs: torch.Tensor,
    kr: torch.Tensor,
    r: torch.Tensor,
    beta_j: torch.Tensor,
    *,
    inv_c0: "torch.Tensor | float",
    chunk_rows: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in X's dtype on X's device: (num, σ², res).

    ``kr`` is k∘r, ``r`` the resolvent column, ``beta_j`` = sign∘β_emb and ``inv_c0`` the
    resolvent scale. Per chunk of ``chunk_rows`` rows the features, Gu = W·Qs in IEEE, and
    Gu·kr, (Gu∘Gu)·r and W·β − y.
    """
    D = M_map.shape[1]
    inv_sqrt_D = 1.0 / torch.sqrt(torch.tensor(D, dtype=X.dtype, device=X.device))
    num_c, sig2_c, res_c = [], [], []
    for start in range(0, X.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        U = X[rows] @ M_map + b_map
        ones = torch.ones((U.shape[0], 1), dtype=X.dtype, device=X.device)
        zeros = torch.zeros((U.shape[0], 1), dtype=X.dtype, device=X.device)
        W_b = torch.cat([torch.cos(U) * inv_sqrt_D, ones, torch.sin(U) * inv_sqrt_D, zeros], dim=1)
        Gu_b = W_b @ Qs
        num_c.append(inv_c0 * (Gu_b @ kr))
        sig2_c.append(inv_c0 * ((Gu_b * Gu_b) @ r))
        res_c.append(W_b @ beta_j - y[rows])
    return torch.cat(num_c), torch.cat(sig2_c), torch.cat(res_c)


def _check_operands(X: torch.Tensor, shapes: dict[str, tuple[int, ...]], **operands: torch.Tensor) -> None:
    """Raise unless every operand is float32, contiguous, of its shape and on X's CUDA device."""
    for name, t in {"X": X, **operands}.items():
        if t.dtype != torch.float32:
            msg = f"fused_pass3 takes float32 tensors, got {name} as {t.dtype}"
            raise ValueError(msg)
        if tuple(t.shape) != shapes[name]:
            msg = f"shape mismatch: {name} is {tuple(t.shape)}, expected {shapes[name]}"
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = f"{name} must be contiguous"
            raise ValueError(msg)
        if t.device != X.device:
            msg = f"{name} is on {t.device}, X on {X.device}"
            raise ValueError(msg)
    if X.device.type != "cuda":
        msg = f"fused_pass3 launches on a CUDA device, got X on {X.device} (pass3_plain runs elsewhere)"
        raise ValueError(msg)


def fused_pass3(
    X: torch.Tensor,
    M_map: torch.Tensor,
    b_map: torch.Tensor,
    y: torch.Tensor,
    Qs: torch.Tensor,
    kr: torch.Tensor,
    r: torch.Tensor,
    beta_j: torch.Tensor,
    *,
    inv_c0: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(num, σ², res), each of shape (n,), on float32 CUDA tensors: :func:`pass3_plain`'s
    function in one launch of ``csrc/pass3.cu``. Raises on another dtype or device, a shape
    that does not fit X and M, or a tensor that is not contiguous."""
    n, d = X.shape
    D = M_map.shape[1] if M_map.ndim == 2 else -1
    M2 = 2 * D + 2
    b_vec = b_map.reshape(-1)
    shapes = {"X": (n, d), "M_map": (d, D), "b_map": (D,), "y": (n,), "Qs": (M2, M2), "kr": (M2,), "r": (M2,),
              "beta_j": (M2,)}
    _check_operands(X, shapes, M_map=M_map, b_map=b_vec, y=y, Qs=Qs, kr=kr, r=r, beta_j=beta_j)
    lib = load_library()
    QB = torch.cat([Qs, beta_j[:, None]], dim=1)  # β rides in column 2M of the product's B operand
    num, sig2, res = (torch.empty(n, dtype=X.dtype, device=X.device) for _ in range(3))
    plan = pass3_plan(n, D)
    workspace = torch.empty(plan["workspace_bytes"] // X.element_size(), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    pointers = (X, M_map, b_vec, y, QB, kr, r, num, sig2, res, workspace)
    with torch.cuda.device(X.device):
        status = lib.neo_pass3_f32(
            *(t.data_ptr() for t in pointers), n, d, D, plan["chunk"], 1.0 / math.sqrt(D), float(inv_c0), stream
        )
    check_status(lib, status, "fused_pass3")
    global launches
    launches += 1
    path_launches[PATH_TF32] += 1
    return num, sig2, res
