"""The float32 kernels' tensor-core arithmetic in torch, on the CPU: TF32 rounding and the
products of the 3×TF32 and one-pass loops, for the tests that hold an emulation of a kernel
to float64. Imports no JAX, so the card's tests can use it too."""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``: half of the 13 dropped bits' range added, then cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(A: torch.Tensor, B: torch.Tensor, passes: int = 3, run_blocks: int | None = None) -> torch.Tensor:
    """A·B as the kernels' product loops compute it, on hi = tf32(v), lo = tf32(v − hi):
    the contraction in runs of ``run_blocks`` k-blocks of 32, each run lo·hi + hi·lo + hi·hi
    (hi·hi alone for ``passes=1``) in float32, the runs added into a float32 sum in order.
    By default a run is what each loop takes: one k-block under 3×TF32
    (``csrc/gemm_sm90.cuh``), the whole contraction under one pass
    (``csrc/gemm_sm90_1xtf32.cuh``)."""
    pad = (-A.shape[1]) % 32
    A = torch.nn.functional.pad(A, (0, pad))
    B = torch.nn.functional.pad(B, (0, 0, 0, pad))
    blocks = A.shape[1] // 32
    if run_blocks is None:
        run_blocks = 1 if passes == 3 else blocks
    A_hi = tf32(A)
    B_hi = tf32(B)
    A_lo = tf32(A - A_hi)
    B_lo = tf32(B - B_hi)
    total = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32)
    for k0 in range(0, A.shape[1], 32 * run_blocks):
        ks = slice(k0, k0 + 32 * run_blocks)
        run = A_hi[:, ks] @ B_hi[ks]
        if passes == 3:
            run = A_lo[:, ks] @ B_hi[ks] + A_hi[:, ks] @ B_lo[ks] + run
        total += run
    return total
