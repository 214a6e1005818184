"""The plain versions of the port's CUDA kernels match the JAX package's Pallas kernels,
and the float32 kernels' 3×TF32 arithmetic keeps f32 accuracy.

The same float64 operands (made from a seed) go through the Pallas kernel in interpret
mode, the plain-XLA reference, and the port's plain PyTorch version, at rtol 1e-10. On
CPU tensors the wrappers must take the plain version and launch nothing. (The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds them against these
plain versions there.) A torch emulation of the kernels' 3×TF32 products, with the same
hi/lo split and k-blocks, is held against the plain versions in float64 under
``chip_smoke.py``'s f32 limits, and one-pass TF32 must break them. The same emulation with
one pass (K2's ``precision="fast"`` path, whose loop accumulates a tile's whole
contraction in one run) is held to ``chip_smoke.py``'s one-pass limits, must stay at least
10× further from float64 than three passes, and moves by less than a tenth of that
distance against one-k-block runs. A CPU tensor runs the plain version in IEEE under
either precision. The kernels' chunk plans must keep their workspace independent of n, in
float32 and in float64; the one-pass plan's tiles cover every column and γ once; the
float64 sweep's plan takes any width. A float64 tensor on another device than the CPU
reaches the float64 (DMMA) entry points, and a "fast" float32 one the one-pass entry,
counted under their paths, with a stand-in library.
"""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.ops.cuda import _build
from neo_ls_svm_torch.ops.cuda import gram as tgram
from neo_ls_svm_torch.ops.cuda import sweep as tsweep
from neo_ls_svm_tpu.models.primal import embed_from_gram_blocks, gamma_grid
from neo_ls_svm_tpu.ops.pallas.gram import (
    augmented_gram_reference,
    fused_augmented_gram,
    w_basis_from_augmented,
)
from neo_ls_svm_tpu.ops.pallas.sweep import fused_loo_sweep

from ._tf32_products import tf32_product as _product

RTOL = 1e-10
N, d, D = 512, 8, 64


def _operands(seed: int, classifier: bool = False, n: int = N) -> dict[str, np.ndarray]:
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d)
    M_map = gen.randn(d, D)
    b_map = gen.uniform(0, 2 * np.pi, (1, D))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * gen.randn(n)
    if classifier:
        y = np.where(y > 0, 1.0, -1.0)
    w = gen.rand(n) + 0.25
    s = w / w.sum()
    return {"X": X, "M_map": M_map, "b_map": b_map, "y": y, "s": s, "s2": s * s}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _sweep_operands(ops: dict[str, np.ndarray], n: int = N) -> dict[str, np.ndarray]:
    """Qs, k and r_all from a real eigendecomposition of the operands' Gram."""
    G_aug = np.asarray(
        augmented_gram_reference(*(jnp.asarray(ops[k]) for k in ("X", "M_map", "b_map", "s2", "y")))
    )
    G_W, b_vec = (np.asarray(a) for a in w_basis_from_augmented(jnp.asarray(G_aug), D))
    M = D + 1
    inv_c0 = float(n * M)
    lam, Q = np.linalg.eigh(inv_c0 * np.asarray(embed_from_gram_blocks(jnp.asarray(G_W), M)))
    Qs = np.concatenate([np.ones(M), -np.ones(M)])[:, None] * Q
    r_all = 1.0 / (gamma_grid(np.float64)[None, :] + lam[:, None])
    return {"Qs": Qs, "r_all": r_all, "k": Qs.T @ b_vec, "inv_c0": inv_c0}


def test_gram_plain_matches_reference_and_pallas() -> None:
    ops = _operands(81)
    args = [ops[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    reference = np.asarray(augmented_gram_reference(*map(jnp.asarray, args)))
    pallas = np.asarray(fused_augmented_gram(*map(jnp.asarray, args), block_rows=256, interpret=True))
    ours = tgram.gram_plain(*map(_t, args)).numpy()
    np.testing.assert_allclose(ours, reference, rtol=RTOL, atol=RTOL * np.abs(reference).max())
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=RTOL * np.abs(pallas).max())


def test_w_basis_from_augmented_matches_jax() -> None:
    G_aug = np.random.RandomState(82).randn(2 * D + 2, 2 * D + 2)
    theirs = w_basis_from_augmented(jnp.asarray(G_aug), D)
    ours = tgram.w_basis_from_augmented(_t(G_aug), D)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_sweep_plain_matches_pallas(task: str) -> None:
    is_classifier = task == "classification"
    ops = _operands(83, classifier=is_classifier)
    sw = _sweep_operands(ops)
    names = ("X", "M_map", "b_map", "y", "s", "s2")
    pallas_err, pallas_obj = fused_loo_sweep(
        *(jnp.asarray(ops[k]) for k in names),
        *(jnp.asarray(sw[k]) for k in ("Qs", "r_all", "k")),
        block_rows=128,
        is_classifier=is_classifier,
        inv_c0_static=sw["inv_c0"],
        interpret=True,
    )
    err, obj = tsweep.sweep_plain(
        *(_t(ops[k]) for k in names),
        *(_t(sw[k]) for k in ("Qs", "r_all", "k")),
        is_classifier=is_classifier,
        inv_c0=sw["inv_c0"],
    )
    np.testing.assert_allclose(err.numpy(), np.asarray(pallas_err), rtol=RTOL)
    np.testing.assert_allclose(obj.numpy(), np.asarray(pallas_obj), rtol=RTOL)


def test_wrappers_route_cpu_tensors_to_plain_versions(monkeypatch) -> None:
    monkeypatch.setattr(tgram, "launches", 0)
    monkeypatch.setattr(tsweep, "launches", 0)
    ops = {k: _t(v) for k, v in _operands(84).items()}
    sw = _sweep_operands({k: v.numpy() for k, v in ops.items()})
    gram_args = [ops[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    torch.testing.assert_close(
        tgram.fused_augmented_gram(*gram_args), tgram.gram_plain(*gram_args), rtol=0, atol=0
    )
    sweep_args = [ops[k] for k in ("X", "M_map", "b_map", "y", "s", "s2")]
    sweep_args += [_t(sw[k]) for k in ("Qs", "r_all", "k")]
    kwargs = {"is_classifier": False, "inv_c0": sw["inv_c0"]}
    for a, b in zip(tsweep.fused_loo_sweep(*sweep_args, **kwargs), tsweep.sweep_plain(*sweep_args, **kwargs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tgram.launches == 0
    assert tsweep.launches == 0


def test_wrappers_reject_other_devices() -> None:
    X = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgram.fused_augmented_gram(X, X, X, X, X)


# The f32 limits of chip_smoke.py: per-entry Gram error max|ΔG_ij|/√(G_ii·G_jj), and the
# sweep's max relative error.
GRAM_TOL_F32, SWEEP_TOL_F32 = 2e-6, 1e-4


def _features32(ops: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """cos U/√D and sin U/√D in float32, U = X·M + b."""
    U = ops["X"] @ ops["M_map"] + ops["b_map"].reshape(1, -1)
    inv_sqrt_D = 1.0 / np.sqrt(ops["M_map"].shape[1])
    return torch.cos(U) * inv_sqrt_D, torch.sin(U) * inv_sqrt_D


def _gram_emulated(ops: dict[str, torch.Tensor], passes: int) -> torch.Tensor:
    """K1's float32 path: G = (sY)ᵀ(sY), s = √s², as one product over the rows."""
    cos, sin = _features32(ops)
    ones = torch.ones((cos.shape[0], 1))
    sY = torch.sqrt(ops["s2"])[:, None] * torch.cat([cos, sin, ones, ops["y"][:, None]], dim=1)
    return _product(sY.T.contiguous(), sY, passes)


@pytest.mark.parametrize(("passes", "within_limit"), [(3, True), (1, False)])
def test_3xtf32_gram_keeps_the_f32_limit_and_one_pass_breaks_it(passes: int, within_limit: bool) -> None:
    n = 4096
    ops64 = {k: _t(v) for k, v in _operands(85, n=n).items()}
    ops32 = {k: v.float() for k, v in ops64.items()}
    ref = tgram.gram_plain(*(ops64[k] for k in ("X", "M_map", "b_map", "s2", "y")))
    G = _gram_emulated(ops32, passes).double()
    scale = ref.diagonal().sqrt()
    err = float(((G - ref).abs() / (scale[:, None] * scale[None, :])).max())
    assert (err <= GRAM_TOL_F32) == within_limit, err


def _sweep_emulated(is_classifier: bool, passes: int, n: int = 2048, run_blocks: int | None = None) -> tuple:
    """K2's float32 path on seed-86 operands: W, Gu = W·Qs, then num and lev against
    r_all, each product in ``passes`` TF32 passes (accumulation runs as ``_product``).
    Returns (err, obj) and the float64 plain version's (err, obj)."""
    ops = _operands(86, classifier=is_classifier, n=n)
    sw = _sweep_operands(ops, n=n)
    t64 = {k: _t(v) for k, v in {**ops, **{k: sw[k] for k in ("Qs", "r_all", "k")}}.items()}
    t32 = {k: v.float() for k, v in t64.items()}
    names = ("X", "M_map", "b_map", "y", "s", "s2", "Qs", "r_all", "k")
    ref_err, ref_obj = tsweep.sweep_plain(
        *(t64[k] for k in names), is_classifier=is_classifier, inv_c0=sw["inv_c0"]
    )
    cos, sin = _features32(t32)
    ones = torch.ones((n, 1))
    W = torch.cat([cos, ones, sin, 0 * ones], dim=1)
    Gu = _product(W, t32["Qs"], passes, run_blocks)
    num = sw["inv_c0"] * _product(Gu * t32["k"][None, :], t32["r_all"], passes, run_blocks)
    lev = sw["inv_c0"] * t32["s2"][:, None] * _product(Gu * Gu, t32["r_all"], passes, run_blocks)
    y = t32["y"][:, None]
    e = (num - y) / (1.0 - lev)
    if is_classifier:
        e = torch.where(((y > 0) & (e > 0)) | ((y < 0) & (e < 0)), torch.zeros_like(e), e)
    abs_e = torch.abs(e)
    err = t32["s"] @ abs_e
    obj = err
    if is_classifier:
        obj = obj + t32["s"] @ (abs_e >= 1).float() + t32["s"] @ torch.clamp(abs_e - 1, min=0.0)
    return err, obj, ref_err, ref_obj


def _max_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((ours.double() - ref).abs() / ref.abs()).max())


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_3xtf32_sweep_keeps_the_f32_limit_and_the_argmin(task: str) -> None:
    # K2's float32 path, every product in 3×TF32.
    err, obj, ref_err, ref_obj = _sweep_emulated(task == "classification", passes=3)
    for ours, ref in ((err, ref_err), (obj, ref_obj)):
        rel = float(((ours.double() - ref).abs() / ref.abs()).max())
        assert rel <= SWEEP_TOL_F32, rel
    # The argmin as chip_smoke.py holds it: the float64 objective at the f32 argmin is
    # within 1e-5 of the float64 minimum. (Here the classifier's objective is flat to
    # 4e-9 over its first γ values, below f32's resolution, so the index itself may move.)
    p_min = float(ref_obj.min())
    assert abs(float(ref_obj[int(torch.argmin(obj))]) - p_min) <= 1e-5 * abs(p_min)


# chip_smoke.py's limits of K2's one-pass path against float64: the LOO error (relative,
# 2.5× this emulation's worst at n = 2048), a regressor's objective, and the float64
# objective at the one-pass argmin against its minimum. A classifier's objective adds
# s·[|e| ≥ 1], whose step one pass flips on the rows near |e| = 1: it is held by its argmin.
SWEEP_TOL_ONE_PASS, SWEEP_OBJ_TOL_ONE_PASS, ARGMIN_GAP_ONE_PASS = 2e-4, 1e-4, 1e-3


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_one_pass_tf32_sweep_keeps_the_fast_limits(task: str) -> None:
    is_classifier = task == "classification"
    err, obj, ref_err, ref_obj = _sweep_emulated(is_classifier, passes=1)
    err_rel = _max_rel(err, ref_err)
    assert err_rel <= SWEEP_TOL_ONE_PASS, err_rel
    if not is_classifier:
        assert _max_rel(obj, ref_obj) <= SWEEP_OBJ_TOL_ONE_PASS
    p_min = float(ref_obj.min())
    gap = abs(float(ref_obj[int(torch.argmin(obj))]) - p_min) / abs(p_min)
    assert gap <= ARGMIN_GAP_ONE_PASS, gap
    # A path that quietly ran three passes would be this close to float64: one pass must
    # be at least 10× further.
    err3 = _sweep_emulated(is_classifier, passes=3)[0]
    assert err_rel >= 10 * _max_rel(err3, ref_err), (err_rel, _max_rel(err3, ref_err))


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_cpu_sweep_is_ieee_under_either_precision(precision: str, monkeypatch) -> None:
    """A CPU tensor runs the plain version in IEEE under "fast" too (bit-equal to "high"),
    and launches nothing."""
    monkeypatch.setattr(tsweep, "launches", 0)
    ops64 = _operands(87)
    sw = _sweep_operands(ops64)
    args = [_t(ops64[k]).float() for k in ("X", "M_map", "b_map", "y", "s", "s2")]
    args += [_t(sw[k]).float() for k in ("Qs", "r_all", "k")]
    kwargs = {"is_classifier": False, "inv_c0": sw["inv_c0"]}
    ours = tsweep.fused_loo_sweep(*args, **kwargs, precision=precision)
    for a, b in zip(ours, tsweep.sweep_plain(*args, **kwargs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tsweep.launches == 0
    with pytest.raises(ValueError, match="sweep_precision"):
        tsweep.fused_loo_sweep(*args, **kwargs, precision="highest")


def test_one_pass_workspace_holds_one_plane() -> None:
    """Under "fast" the sweep's workspace holds one plane of each matrix: W's TF32 values and
    Gu in float32 (the one-pass sweep forms Gu∘k and Gu∘Gu from Gu in registers, so neither
    is stored), Qsᵀ and r_allᵀ padded to the one-pass tiles (6 × 176 = 1056 at D = 512,
    G = 1024), k, and the row-tile partials: twice the row chunk of "high" (its persistent
    kernels start and drain once a chunk) in under two thirds of its bytes, whatever n."""
    high, fast = tsweep.sweep_plan(2**20, 512, 1024), tsweep.sweep_plan(2**20, 512, 1024, "fast")
    assert fast["chunk"] == 2 * high["chunk"]
    assert fast["workspace_bytes"] < high["workspace_bytes"] / 1.5
    assert tsweep.sweep_plan(2**15, 512, 1024, "fast") == fast
    chunk, Kp = fast["chunk"], 1056
    assert fast["workspace_bytes"] == 4 * (2 * chunk * Kp + 1056 * Kp + 1056 * Kp + Kp + 2 * (chunk // 128) * 1056)


def _spans(tiles: int, width: int, size: int) -> list[range]:
    """The indices below ``size`` that each of ``tiles`` tiles of ``width`` covers."""
    return [range(t * width, min((t + 1) * width, size)) for t in range(tiles)]


# The shapes chip_smoke.py runs through the one-pass kernels: its ragged cases and the
# 1M fit (whose plan alone is checked here).
@pytest.mark.parametrize(("n", "D", "G"), [(3001, 100, 1001), (20011, 1800, 130), (2**20, 512, 1024)])
def test_one_pass_plan_covers_every_column_and_gamma_once(n: int, D: int, G: int) -> None:
    """``csrc/sweep_1xtf32.cu``'s tiles: 176 columns of Gu and 176 values of γ a tile (its
    blocks share no tiles: no cluster). Every column of 2M and every γ lies in exactly one
    tile, no tile lies wholly in padding (the γ tail is one partly filled tile), and the
    workspace is bounded by the chunk (a multiple of the Gu tile's 256 rows), not by n."""
    plan = tsweep.sweep_plan(n, D, G, "fast")
    M2 = 2 * D + 2
    Kp = -(-M2 // 32) * 32
    assert (plan["tile"], plan["row_tile"]) == (176, 256)
    for tiles, size in ((plan["col_tiles"], M2), (plan["gamma_tiles"], G)):
        covered = [i for span in _spans(tiles, plan["tile"], size) for i in span]
        assert covered == list(range(size))  # each index once, in order
        assert (tiles - 1) * 176 < size  # the last tile holds at least one index
    assert (plan["col_tiles"] - 1) * 176 < Kp <= plan["col_tiles"] * 176
    assert plan["chunk"] % 256 == 0 and plan["chunk"] <= 32768
    assert min(n, 32768) <= plan["chunk"] < min(n, 32768) + 256
    Nq = -(-(plan["col_tiles"] * 176) // 32) * 32
    Gq = plan["gamma_tiles"] * 176
    Gr = -(-Gq // 32) * 32
    chunk = plan["chunk"]
    assert plan["workspace_bytes"] == 4 * (2 * chunk * Kp + Nq * Kp + Gr * Kp + Kp + 2 * (chunk // 128) * Gq)
    assert tsweep.sweep_plan(64 * n, D, G, "fast") == tsweep.sweep_plan(2**24, D, G, "fast")
    assert plan["workspace_bytes"] <= tsweep.sweep_plan(2**24, D, G, "fast")["workspace_bytes"]


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_one_pass_run_length_moves_the_sweep_far_less_than_one_pass(task: str) -> None:
    """The one-pass loop accumulates a tile's whole contraction in one run; summing
    one-k-block runs in IEEE instead moves the sweep by less than a tenth of one pass's
    distance from float64 on the same operands."""
    is_classifier = task == "classification"
    whole, _, ref_err, _ = _sweep_emulated(is_classifier, passes=1)
    blocks, _, _, _ = _sweep_emulated(is_classifier, passes=1, run_blocks=1)
    assert _max_rel(whole, blocks.double()) <= 0.1 * _max_rel(whole, ref_err)


@pytest.mark.parametrize("kernel", ["gram", "sweep"])
def test_f32_workspace_is_bounded_by_the_row_chunk(kernel: str) -> None:
    def plan(n: int) -> dict[str, int]:
        return tgram.gram_plan(n, 512) if kernel == "gram" else tsweep.sweep_plan(n, 512, 1024)

    assert plan(2**14) == plan(2**20)
    assert plan(2**20)["chunk"] <= 16384
    small = plan(3001)
    assert 3001 <= small["chunk"] < 3001 + 128
    assert small["workspace_bytes"] < plan(2**20)["workspace_bytes"]


@pytest.mark.parametrize("kernel", ["gram", "sweep"])
def test_f64_workspace_is_bounded_by_the_row_chunk(kernel: str) -> None:
    def plan(n: int) -> dict[str, int]:
        if kernel == "gram":
            return tgram.gram_plan(n, 512, torch.float64)
        return tsweep.sweep_plan(n, 512, 1024, dtype=torch.float64)

    assert plan(2**14) == plan(2**20)
    assert plan(2**20)["chunk"] <= 16384
    small = plan(3001)
    assert 3001 <= small["chunk"] < 3001 + 128
    assert small["workspace_bytes"] < plan(2**20)["workspace_bytes"]


@pytest.mark.parametrize("D", [3631, 4096])
def test_f64_sweep_plan_takes_any_width(D: int) -> None:
    """The float64 sweep passes Gu∘k and Gu∘Gu through its workspace, not shared memory:
    a width that the CUDA-core kernel refused gets a plan, bounded by the chunk, the same
    under either precision (float64 has one path)."""
    plan = tsweep.sweep_plan(2**20, D, 1024, dtype=torch.float64)
    assert plan == tsweep.sweep_plan(2**14, D, 1024, "fast", torch.float64)
    Kp = -(-(2 * D + 2) // 16) * 16
    assert plan["chunk"] == 16384
    assert plan["workspace_bytes"] >= 8 * 3 * plan["chunk"] * Kp


class _Library:
    """A stand-in for the kernels' library: each entry point records its arguments and
    returns 0 (cudaSuccess)."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, tuple]] = []

    def __getattr__(self, name: str):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _stand_in_library(monkeypatch) -> _Library:
    """A stand-in library behind both wrappers, on a machine with no card."""
    lib = _Library()
    for mod in (tgram, tsweep):
        monkeypatch.setattr(mod, "load_library", lambda: lib)
        monkeypatch.setattr(mod, "check_operands", lambda *args, **kwargs: None)
        monkeypatch.setattr(mod, "launches", 0)
        monkeypatch.setattr(mod, "path_launches", dict.fromkeys(mod.path_launches, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


def _meta(*shape: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Not a CPU tensor, and nothing is allocated."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_float64_device_tensors_take_the_dmma_path(precision: str, monkeypatch) -> None:
    lib = _stand_in_library(monkeypatch)

    n, d, D, G = 3001, 5, 4096, 77
    M2 = 2 * D + 2
    tgram.fused_augmented_gram(_meta(n, d), _meta(d, D), _meta(1, D), _meta(n), _meta(n))
    tsweep.fused_loo_sweep(_meta(n, d), _meta(d, D), _meta(1, D), _meta(n), _meta(n), _meta(n), _meta(M2, M2),
                           _meta(M2, G), _meta(M2), is_classifier=False, inv_c0=1.0, precision=precision)
    assert [name for name, _ in lib.calls] == ["neo_gram_f64", "neo_sweep_f64"]
    assert _build.PATH_FP64 == "fp64-dmma"
    assert (tgram.launches, tsweep.launches) == (1, 1)
    assert tgram.path_launches == {_build.PATH_TF32: 0, _build.PATH_FP64: 1}
    assert tsweep.path_launches == {_build.PATH_TF32: 0, _build.PATH_TF32_1: 0, _build.PATH_FP64: 1}
    gram_plan = tgram.gram_plan(n, D, torch.float64)
    assert lib.calls[0][1][7:13] == (n, d, D, gram_plan["chunk"], gram_plan["splits"], gram_plan["kb_per_split"])
    assert lib.calls[1][1][12:18] == (n, d, D, G, tsweep.sweep_plan(n, D, G, dtype=torch.float64)["chunk"], 0)


def test_fast_float32_device_tensors_take_the_one_pass_entry(monkeypatch) -> None:
    """Under "fast" a float32 tensor off the CPU reaches neo_sweep_f32 with passes = 1 and
    the one-pass plan's chunk and workspace, counted under the one-pass path."""
    lib = _stand_in_library(monkeypatch)
    captured = {}
    empty = torch.empty

    def record_empty(*shape, **kwargs):
        captured["workspace"] = shape
        return empty(*shape, **kwargs)

    n, d, D, G = 20011, 5, 1800, 130
    M2 = 2 * D + 2
    args = [_meta(*shape, dtype=torch.float32) for shape in ((n, d), (d, D), (1, D), (n,), (n,), (n,), (M2, M2), (M2, G), (M2,))]
    monkeypatch.setattr(torch, "empty", record_empty)
    tsweep.fused_loo_sweep(*args, is_classifier=True, inv_c0=1.0, precision="fast")
    monkeypatch.setattr(torch, "empty", empty)
    plan = tsweep.sweep_plan(n, D, G, "fast")
    assert [name for name, _ in lib.calls] == ["neo_sweep_f32"]
    assert lib.calls[0][1][12:19] == (n, d, D, G, plan["chunk"], 1, 1)  # ..., is_classifier, passes
    assert captured["workspace"] == (plan["workspace_bytes"] // 4,)
    assert tsweep.path_launches == {_build.PATH_TF32: 0, _build.PATH_TF32_1: 1, _build.PATH_FP64: 0}
