"""The port's native host loops (``neo_ls_svm_torch/native``) against the Python loops.

The C++ loops run the same operations in the same order as the Python loops they stand in
for, so every comparison here is **bit for bit** (``assert_array_equal``, no tolerance):
``pav_fit`` against ``models.isotonic._pav_python``, ``knot_scan`` against
``ops.quantizer._scan_knot``, and the histogram built on either scan, which also equals the
JAX package's. Which loops ran is visible: ``native.backend()`` and the ``native.calls``
counters. The library is built under ``build/``, never next to the sources.
"""

from pathlib import Path

import numpy as np
import pytest

from neo_ls_svm_torch import native
from neo_ls_svm_torch.models.isotonic import _pav_python, pool_adjacent_violators
from neo_ls_svm_torch.ops import quantizer as t_quantizer
from neo_ls_svm_tpu.ops import quantizer as j_quantizer

REPO = Path(__file__).resolve().parents[1]


def test_the_native_library_is_built_under_build_and_is_the_backend() -> None:
    assert native.load() is not None
    assert native.available() and native.backend() == "native"
    package = REPO / "neo_ls_svm_torch" / "native"
    assert not list(package.glob("*.so")), "a library was built next to the sources"
    built = list((REPO / "build" / "neo_ls_svm_torch").glob("native-*/libneo_ls_svm_native.so"))
    assert built, "no native library under build/neo_ls_svm_torch/"


def test_backend_says_python_when_the_python_loops_are_forced(monkeypatch) -> None:
    monkeypatch.setattr(native, "_FORCE_PYTHON", True)
    assert native.backend() == "python" and not native.available()
    before = dict(native.calls)
    pool_adjacent_violators(np.array([3.0, 1.0, 2.0]), np.ones(3))
    t_quantizer.hist_quantized_ecdf(np.arange(100.0))
    assert native.calls == before


_PAV_CASES = {
    "random_1000": (0, 1000, None),
    "random_20000": (1, 20000, None),
    "rounded_with_ties": (2, 5000, 1),
    "binary_targets": (3, 5000, 0),
    "one_point": (4, 1, None),
    "already_monotone": (5, 300, "sorted"),
    "reversed": (6, 300, "reversed"),
}


@pytest.mark.parametrize("case", sorted(_PAV_CASES))
def test_pav_fit_equals_the_python_loop_bit_for_bit(case: str) -> None:
    seed, n, how = _PAV_CASES[case]
    gen = np.random.RandomState(seed)
    y, w = gen.randn(n), gen.rand(n) + 0.05
    if isinstance(how, int):
        y = np.round(y, how)
    elif how == "sorted":
        y = np.sort(y)
    elif how == "reversed":
        y = np.sort(y)[::-1].copy()
    before = native.calls["pav_fit"]
    ours = pool_adjacent_violators(y, w)
    assert native.calls["pav_fit"] == before + 1
    np.testing.assert_array_equal(ours, _pav_python(y, w))  # bit-equal
    assert np.all(np.diff(ours) >= 0)


def test_pav_fit_rejects_operands_the_c_loop_would_misread() -> None:
    with pytest.raises(ValueError, match="one length"):
        native.pav_fit(np.zeros(4), np.ones(3))
    assert native.pav_fit(np.zeros(0), np.zeros(0)).shape == (0,)


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knot_scan_equals_the_python_scan(seed: int, direction: int) -> None:
    gen = np.random.RandomState(seed)
    uniq = np.sort(gen.randn(400).round(2 if seed else 6))
    uniq = np.unique(uniq)
    counts = gen.randint(1, 9, size=len(uniq))
    xs = np.concatenate(([-np.inf], uniq, [np.inf]))
    ys = np.concatenate(([0], np.cumsum(counts), [np.iinfo(np.int64).max])).astype(np.int64)
    total = int(counts.sum())
    for knot in (1, 7, len(xs) // 2, len(xs) - 2):
        for err, size in ((int(0.0125 * total), int(0.125 * total)), (3, 40), (0, total)):
            start = knot if direction > 0 else len(xs) - 1 - knot + 1
            assert native.knot_scan(xs, ys, start, err, size, direction) == t_quantizer._scan_knot(
                xs, ys, start, err, size, direction
            )


def test_knot_scan_rejects_operands_the_c_loop_would_misread() -> None:
    xs, ys = np.zeros(5), np.zeros(5, dtype=np.int64)
    with pytest.raises(TypeError, match="float64/int64"):
        native.knot_scan(xs.astype(np.float32), ys, 1, 1, 1, 1)
    with pytest.raises(TypeError, match="float64/int64"):
        native.knot_scan(xs, ys[:4], 1, 1, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        native.knot_scan(np.zeros(10)[::2], ys, 1, 1, 1, 1)


_HIST_CASES = {
    "normal_f64": lambda g: g.randn(20000),
    "normal_f32": lambda g: g.randn(20000).astype(np.float32),
    "integer_codes": lambda g: np.unique(g.randn(30000), return_inverse=True)[1],
    "few_values": lambda g: g.randint(0, 40, size=5000).astype(np.float64),
    "heavy_tail": lambda g: np.exp(3 * g.randn(20000)),
}


@pytest.mark.parametrize("case", sorted(_HIST_CASES))
def test_histogram_is_the_same_on_either_scan_and_in_the_jax_package(case: str, monkeypatch) -> None:
    x = _HIST_CASES[case](np.random.RandomState(11))
    before = native.calls["knot_scan"]
    hist, edges = t_quantizer.hist_quantized_ecdf(x)
    assert native.calls["knot_scan"] > before
    monkeypatch.setattr(native, "_FORCE_PYTHON", True)
    hist_py, edges_py = t_quantizer.hist_quantized_ecdf(x)
    hist_j, edges_j = j_quantizer.hist_quantized_ecdf(x)
    for other_hist, other_edges in ((hist_py, edges_py), (hist_j, edges_j)):
        np.testing.assert_array_equal(hist, other_hist)  # bit-equal
        np.testing.assert_array_equal(edges, other_edges)


def test_sample_bins_equal_the_jax_package() -> None:
    y = np.random.RandomState(5).randn(40000)
    np.testing.assert_array_equal(
        t_quantizer.sample_bins_quantized_ecdf(y), j_quantizer.sample_bins_quantized_ecdf(y)
    )
