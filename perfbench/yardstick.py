"""The work of the fit counted from its shapes, and the card's peaks: the yardstick of the
roofline shares and of ``fit.mfu``.

A kernel's operations are those its output needs, whatever computes it, and its bytes are
its inputs read once and its outputs written once: no pass count, no workspace, no padding
rows. The bound is the larger of the operations at the dense peak of the operands' dtype
(``peaks.json``: TF32 for float32, the FP64 tensor cores for float64) and the bytes at the
HBM rate. A share of it cannot pass 100% unless the count or the time is wrong.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(device_kind: str) -> dict | None:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_kind)


def k1_work(n: int, d: int, D: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of the augmented Gram YᵀS²Y, Y = [cos U | sin U | 1 | y] of
    U = X·M + b (K = 2D + 2 columns): the phases 2ndD and the upper triangle n·K·(K+1);
    X, M, b, s², y in and the K×K Gram out."""
    K = 2 * D + 2
    ops = n * K * (K + 1) + 2 * n * d * D
    nbytes = itemsize * (n * d + d * D + D + 2 * n + K * K)
    return float(ops), float(nbytes)


def k2_work(n: int, d: int, D: int, G: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of the LOO sweep over G values of γ (M₂ = 2D + 2): the phases
    2ndD, Gu = W·Qs 2nM₂², the two contractions (Gu∘k)·R and (Gu∘Gu)·R 4nM₂G; X, M, b,
    y, s, s², Qs, R, k in and the two G-vectors out."""
    M2 = 2 * D + 2
    ops = 2 * n * M2 * M2 + 4 * n * M2 * G + 2 * n * d * D
    nbytes = itemsize * (n * d + d * D + D + 3 * n + M2 * M2 + M2 * G + M2 + 2 * G)
    return float(ops), float(nbytes)


def fit_flops(n: int, d: int, D: int, G: int) -> float:
    """Model operations of one streaming fit, each product once: the phases 2ndD, the
    augmented Gram, Gu and the two sweep contractions, the per-row products at the optimum
    (Gu·(k∘r), (Gu∘Gu)·r, W·β: 6nM₂; Gu is counted once, with the sweep), and the
    eigendecomposition of the M₂×M₂ embedding at 9·M₂³ (tridiagonal reduction and the
    accumulation of its eigenvectors)."""
    M2 = 2 * D + 2
    K = M2
    ops = 2 * n * d * D + n * K * (K + 1) + 2 * n * M2 * M2 + 4 * n * M2 * G + 6 * n * M2 + 9 * M2**3
    return float(ops)


def bound_ms(ops: float, nbytes: float, dtype: str, card: dict) -> float:
    """The least time, in ms, for ``ops`` operations and ``nbytes`` bytes on ``card``."""
    return max(ops / (card["tflops"][dtype] * 1e9), nbytes / (card["hbm_tbs"] * 1e9))
