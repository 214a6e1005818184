"""The work that the roofline shares and fit.mfu count, against counts made by hand."""

import pytest

from perfbench import yardstick


def _gram_by_hand(n, d, D):
    K = 2 * D + 2
    phases = n * D * d * 2  # one multiply and one add per term of X·M
    upper = sum(2 for _ in range(n) for i in range(K) for j in range(i, K))  # Yᵢ·Yⱼ·s², summed
    return phases + upper


def _sweep_by_hand(n, d, D, G):
    M2 = 2 * D + 2
    phases = 2 * n * d * D
    gu = n * M2 * M2 * 2
    contractions = 2 * (n * G * M2 * 2)
    return phases + gu + contractions


@pytest.mark.parametrize(("n", "d", "D"), [(1, 1, 1), (3, 2, 4), (7, 5, 3)])
def test_k1_operations(n, d, D):
    ops, nbytes = yardstick.k1_work(n, d, D, 4)
    assert ops == _gram_by_hand(n, d, D)
    K = 2 * D + 2
    assert nbytes == 4 * (n * d + d * D + D + n + n + K * K)


@pytest.mark.parametrize(("n", "d", "D", "G"), [(1, 1, 1, 1), (3, 2, 4, 5), (7, 5, 3, 2)])
def test_k2_operations(n, d, D, G):
    ops, nbytes = yardstick.k2_work(n, d, D, G, 8)
    assert ops == _sweep_by_hand(n, d, D, G)
    M2 = 2 * D + 2
    assert nbytes == 8 * (n * d + d * D + D + 3 * n + M2 * M2 + M2 * G + M2 + 2 * G)


def test_fit_flops_counts_each_product_once():
    n, d, D, G = 5, 3, 2, 4
    M2 = 2 * D + 2
    k1, _ = yardstick.k1_work(n, d, D, 4)
    k2, _ = yardstick.k2_work(n, d, D, G, 4)
    # the phases are in both kernels' counts; the fit counts them once
    assert yardstick.fit_flops(n, d, D, G) == k1 + k2 - 2 * n * d * D + 6 * n * M2 + 9 * M2**3


def test_bound_takes_the_larger_of_operations_and_bytes():
    card = {"tflops": {"float32": 1.0}, "hbm_tbs": 1.0}
    assert yardstick.bound_ms(2e9, 1e9, "float32", card) == pytest.approx(2.0)
    assert yardstick.bound_ms(1e9, 3e9, "float32", card) == pytest.approx(3.0)
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["tflops"] == {"float32": 495.0, "float64": 67.0}
    assert yardstick.peaks("a card the table does not hold") is None
