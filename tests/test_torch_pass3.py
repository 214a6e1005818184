"""K3, the streaming solver's third pass (``neo_ls_svm_torch/ops/cuda/pass3.py``,
``csrc/pass3.cu``): num = inv_c0·Gu·(k∘r), σ² = inv_c0·(Gu∘Gu)·r and the residual W·β − y of
every row at the chosen γ.

On the CPU: the plain version against a float64 NumPy computation, with zero-weight padding
rows and on the whitened-GEVD path (inv_c0 = 1); the streaming solver on CPU tensors through
the plain version, bit-equal to the inline loop that computed pass 3 before K3, with no launch
and the span's ``path`` "plain"; the wrapper's checks; the kernel's chunk plan; and a torch
emulation of the kernel's arithmetic (TF32 hi/lo split, three products, accumulation runs of
one 32-column k-block) held to ``higgs.fit``'s ``loo_err`` and ``resid_err`` limits against
float64, which one TF32 pass breaks.

The tests marked ``chip`` run the kernel on the card and skip without one: against the plain
version in float64, twice for the same bits, and once per float32 streaming fit. This file
imports no JAX, so the card's Python runs it:
``python -m pytest -c /dev/null --noconftest -p no:cacheprovider tests/test_torch_pass3.py -m chip``.
"""

import numpy as np
import pytest
import torch

from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.models import estimator
from neo_ls_svm_torch.models import primal
from neo_ls_svm_torch.ops.cuda import _build
from neo_ls_svm_torch.ops.cuda import pass3 as tpass3
from neo_ls_svm_torch.utils import profiling

from ._tf32_products import tf32_product

# higgs.fit's limits (perfbench/workloads/higgs.fit.json), over the target's sd: the LOO
# predictions y + e and the training residuals against float64 on the program's operands.
LOO_ERR_LIMIT, RESID_ERR_LIMIT = 1e-4, 7e-4
ROW_CHUNK = 1024


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m chip")
    return torch.device("cuda", 0)


def _rows(task: str, n: int, d: int, D: int, seed: int) -> dict[str, np.ndarray]:
    """Rows, a random Fourier map and a target: ±1 for a classifier."""
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d)
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.3 * gen.randn(n)
    if task == "classification":
        y = np.where(y > 0, 1.0, -1.0)
    return {"X": X, "M": gen.randn(d, D) * 1.5 / np.sqrt(d), "b": gen.uniform(0, 2 * np.pi, (1, D)), "y": y}


def _complexity(D: int, n: int, seed: int) -> torch.Tensor:
    """A normalised complexity matrix in the real embedding that is not the identity, as
    ``models/estimator.py::_complexity_embedding`` makes it: the fit takes the GEVD path."""
    gen = np.random.RandomState(seed)
    A = gen.randn(D + 1, D + 1)
    C = A @ A.T / (D + 1) + np.eye(D + 1)
    C_n = C / (np.mean(np.abs(np.diag(C))) * n * (D + 1))
    zeros = np.zeros_like(C_n)
    return torch.from_numpy(np.block([[C_n, zeros], [zeros, C_n]]))


def _fit_pass3(task: str, n: int, D: int, *, d: int = 6, pad_to: int = ROW_CHUNK, seed: int = 5,
               dtype: torch.dtype = torch.float64, device: "torch.device | str" = "cpu",
               monkeypatch: pytest.MonkeyPatch) -> tuple:
    """A streaming fit of n rows, padded with zero-weight rows to a multiple of ``pad_to``
    (the GEVD path for task "gevd", a regressor's target), with a spy on ``pass3_plain``.
    Returns the fit's result, its call of the plain version (args, kwargs, output), the
    weights s and s², and whether it was a classifier."""
    is_classifier = task == "classification"
    rows = _rows(task, n, d, D, seed)
    n_pad = -(-n // pad_to) * pad_to
    w = np.zeros(n_pad)
    w[:n] = 1.0
    pad = {"X": np.zeros((n_pad - n, d)), "y": np.zeros(n_pad - n)}
    t = {k: torch.from_numpy(np.concatenate([v, pad[k]]) if k in pad else v).to(device, dtype) for k, v in rows.items()}
    sw = torch.from_numpy(w).to(device, dtype)
    C_emb = _complexity(D, n, seed).to(device, dtype) if task == "gevd" else None
    calls = []
    real = primal.pass3_plain

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(primal, "pass3_plain", spy)
    gammas = torch.from_numpy(primal.gamma_grid(np.float64)).to(device, dtype)
    result = primal.primal_fit_streaming(t["X"], t["M"], t["b"], t["y"], sw, gammas, C_emb, is_classifier=is_classifier,
                                         row_chunk=pad_to, num_samples=n)
    monkeypatch.setattr(primal, "pass3_plain", real)
    s = sw / sw.sum()
    return result, calls, s, s * s, is_classifier


def _numpy_pass3(args: tuple, inv_c0: float) -> tuple[np.ndarray, ...]:
    """num, σ² and the residual in float64 NumPy, on the whole block of rows at once."""
    X, M, b, y, Qs, kr, r, beta_j = (a.double().cpu().numpy() for a in args)
    U = X @ M + b.reshape(1, -1)
    D = M.shape[1]
    one = np.ones((X.shape[0], 1))
    W = np.hstack([np.cos(U) / np.sqrt(D), one, np.sin(U) / np.sqrt(D), 0 * one])
    Gu = W @ Qs
    return inv_c0 * (Gu @ kr), inv_c0 * ((Gu * Gu) @ r), W @ beta_j - y


@pytest.mark.parametrize("task", ["regression", "classification", "gevd"])
def test_pass3_plain_matches_float64_numpy(task: str, monkeypatch: pytest.MonkeyPatch) -> None:
    """On the operands of a float64 fit of 3,000 rows padded to 3,072 with zero-weight rows:
    the identity complexity matrix (inv_c0 = n·M) or the GEVD path (inv_c0 = 1)."""
    n, D = 3000, 24
    _, calls, _, _, _ = _fit_pass3(task, n, D, monkeypatch=monkeypatch)
    (args, kwargs, _), = calls
    inv_c0 = float(kwargs["inv_c0"])
    assert inv_c0 == (1.0 if task == "gevd" else float(n * (D + 1)))
    assert args[0].shape[0] == 3072 and kwargs["chunk_rows"] == ROW_CHUNK
    ours = tpass3.pass3_plain(*args, inv_c0=inv_c0, chunk_rows=512)
    for got, want in zip(ours, _numpy_pass3(args, inv_c0)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def _former_pass3(args: tuple, inv_c0: torch.Tensor, y: torch.Tensor, s: torch.Tensor, s2: torch.Tensor,
                  is_classifier: bool, row_chunk: int) -> dict[str, torch.Tensor]:
    """The solver's pass 3 as its inline loop computed it before K3, on the same operands."""
    X, M_map, b_map, _, Qs, kr_opt, r_opt, beta_j = args
    e_raw_c, lev_c, sig2_c, resid_c = [], [], [], []
    for start in range(0, X.shape[0], row_chunk):
        rows = slice(start, start + row_chunk)
        W_b = primal._features_real_pair(X[rows], M_map, b_map)
        Gu_b = W_b @ Qs
        num = inv_c0 * (Gu_b @ kr_opt)
        sig2 = inv_c0 * ((Gu_b * Gu_b) @ r_opt)
        lev = s2[rows] * sig2
        e_raw_c.append((num - y[rows]) / (1.0 - lev))
        lev_c.append(lev)
        sig2_c.append(sig2)
        resid_c.append(W_b @ beta_j - y[rows])
    e_raw = torch.cat(e_raw_c)
    lev_opt = torch.cat(lev_c)
    sigma2 = torch.cat(sig2_c)
    e_clipped = primal._clip_classifier_residuals(e_raw, y, is_classifier)
    return {
        "loo_residuals": e_clipped,
        "loo_yhat": y + e_clipped,
        "loo_leverage": lev_opt,
        "loo_std": torch.sqrt(sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)),
        "residuals": primal._clip_classifier_residuals(torch.cat(resid_c), y, is_classifier),
        "loo_score": primal._loo_score(y, s, e_raw, is_classifier),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_cpu_streaming_fit_runs_the_plain_version_bit_for_bit(
    task: str, dtype: torch.dtype, monkeypatch: pytest.MonkeyPatch
) -> None:
    """CPU tensors take ``pass3_plain`` once, launch nothing, and every per-row output of the
    fit is bit-equal to what the former inline loop gives on the same operands."""
    monkeypatch.setattr(tpass3, "launches", 0)
    monkeypatch.setattr(tpass3, "path_launches", dict.fromkeys(tpass3.path_launches, 0))
    result, calls, s, s2, is_classifier = _fit_pass3(task, 2500, 16, dtype=dtype, monkeypatch=monkeypatch)
    (args, kwargs, out), = calls
    assert all(a.dtype == dtype for a in args) and kwargs["inv_c0"].dtype == dtype
    for a, b in zip(out, tpass3.pass3_plain(*args, **kwargs)):
        assert torch.equal(a, b)
    former = _former_pass3(args, kwargs["inv_c0"], args[3], s, s2, is_classifier, ROW_CHUNK)
    for key, want in former.items():
        assert result[key].dtype == dtype and torch.equal(result[key], want), key
    assert tpass3.launches == 0 and tpass3.path_launches == {_build.PATH_TF32: 0}


def test_cpu_pass3_span_says_plain(monkeypatch: pytest.MonkeyPatch) -> None:
    """The span of pass 3 names the path it took: "plain" on CPU tensors."""
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _fit_pass3("regression", 1500, 8, monkeypatch=monkeypatch)
    (record,) = [r for r in profiling.spans() if r["name"] == "neo.solve.pass3"]
    assert record["attrs"] == {"path": "plain"}
    profiling.clear_spans()


def _wrapper_operands(n: int = 300, d: int = 3, D: int = 8) -> dict[str, torch.Tensor]:
    M2 = 2 * D + 2
    shapes = {"X": (n, d), "M_map": (d, D), "b_map": (1, D), "y": (n,), "Qs": (M2, M2), "kr": (M2,), "r": (M2,),
              "beta_j": (M2,)}
    return {k: torch.ones(shape) for k, shape in shapes.items()}


@pytest.mark.parametrize(
    ("fault", "match"),
    [("dtype", "float32"), ("shape", "shape mismatch"), ("contiguity", "contiguous"), ("device", "CUDA device")],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(fault: str, match: str, monkeypatch) -> None:
    """The wrapper launches on float32 CUDA tensors of the kernel's shapes or raises: a
    float64 operand, a basis of the wrong width, a strided X, or CPU tensors (the solver
    runs ``pass3_plain`` there)."""
    monkeypatch.setattr(tpass3, "launches", 0)
    ops = _wrapper_operands()
    if fault == "dtype":
        ops["r"] = ops["r"].double()
    elif fault == "shape":
        ops["Qs"] = ops["Qs"][:, :-1].contiguous()
    elif fault == "contiguity":
        ops["X"] = torch.ones(ops["X"].shape[::-1]).T
    with pytest.raises(ValueError, match=match):
        tpass3.fused_pass3(*ops.values(), inv_c0=1.0)
    assert tpass3.launches == 0


@pytest.mark.parametrize(("n", "D"), [(3001, 63), (2**20, 512), (20011, 1800)])
def test_plan_covers_the_basis_and_the_residual_column(n: int, D: int) -> None:
    """The column tiles hold the 2M columns of Qs and β's column 2M, none wholly padding;
    the workspace is bounded by the chunk (a multiple of 128 rows, at most 16,384), not by n."""
    plan = tpass3.pass3_plan(n, D)
    M2 = 2 * D + 2
    Kp = -(-M2 // 32) * 32
    assert (plan["col_tiles"] - 1) * 128 < M2 + 1 <= plan["col_tiles"] * 128
    assert plan["chunk"] % 128 == 0 and min(n, 16384) <= plan["chunk"] < min(n, 16384) + 128
    chunk, Np = plan["chunk"], plan["col_tiles"] * 128
    assert plan["workspace_bytes"] == 4 * (2 * chunk * Kp + 2 * Np * Kp + 2 * plan["col_tiles"] * chunk)
    assert tpass3.pass3_plan(64 * n, D) == tpass3.pass3_plan(2**24, D)


def _tail(num: torch.Tensor, sig2: torch.Tensor, res: torch.Tensor, y: torch.Tensor, s2: torch.Tensor,
          is_classifier: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The LOO predictions y + e and the training residuals, as the solver forms them."""
    e = primal._clip_classifier_residuals((num - y) / (1.0 - s2 * sig2), y, is_classifier)
    return y + e, primal._clip_classifier_residuals(res, y, is_classifier)


def _emulated(args: tuple, inv_c0: float, passes: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's float32 arithmetic: W in IEEE float32, Gu = W·[Qs | β] in ``passes`` TF32 passes
    (accumulation runs of one k-block under three), each 128-column tile's sums over its
    columns in float32, the tiles' partials added in order, then scaled by 1/c₀."""
    X, M_map, b_map, y, Qs, kr, r, beta_j = (a.float() for a in args)
    W = primal._features_real_pair(X, M_map, b_map)
    Gu = tf32_product(W, torch.cat([Qs, beta_j[:, None]], dim=1), passes)
    M2 = Qs.shape[0]
    num, sig2 = torch.zeros(X.shape[0]), torch.zeros(X.shape[0])
    for c0 in range(0, M2, 128):
        cols = slice(c0, min(c0 + 128, M2))
        num += (Gu[:, cols] * kr[cols]).sum(dim=1)
        sig2 += (Gu[:, cols] * Gu[:, cols] * r[cols]).sum(dim=1)
    inv = np.float32(inv_c0)
    return inv * num, inv * sig2, Gu[:, M2] - y


@pytest.mark.parametrize(("passes", "within_limits"), [(3, True), (1, False)])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_3xtf32_pass3_keeps_the_higgs_limits_and_one_pass_breaks_them(
    task: str, passes: int, within_limits: bool, monkeypatch: pytest.MonkeyPatch
) -> None:
    """At D = 512 (2M = 1026, K3's nine column tiles) on 2,048 rows: the emulated kernel's
    LOO predictions and training residuals against float64 on the same float32 operands
    (as ``perfbench/fitcheck.py`` reads ``loo_err`` and ``resid_err``). Three passes read
    about 7e-7 of the sd on both; one pass reads about 4.5e-4 on the LOO predictions."""
    n = 2048
    _, calls, _, s2, is_classifier = _fit_pass3(task, n, 512, d=28, pad_to=n, monkeypatch=monkeypatch)
    (args, _, _), = calls
    args32 = [a.float() for a in args]
    inv_c0 = float(n * 513)
    y = args32[3].double()
    ref = _tail(*tpass3.pass3_plain(*(a.double() for a in args32), inv_c0=inv_c0), y, s2, is_classifier)
    ours = _tail(*(v.double() for v in _emulated(args32, inv_c0, passes)), y, s2, is_classifier)
    sd = float(y.std())
    loo_err, resid_err = (float((a - b).abs().max()) / sd for a, b in zip(ours, ref))
    assert (loo_err <= LOO_ERR_LIMIT and resid_err <= RESID_ERR_LIMIT) == within_limits, (loo_err, resid_err)
    if within_limits:
        assert max(loo_err, resid_err) <= 1e-5, (loo_err, resid_err)


# ---- on the card ----

# K3 against float64 on the same float32 operands, over the target's sd (num, the residual)
# or the largest σ²: 15× the emulation's 7e-7, and a tenth of higgs.fit's LOO limit.
CARD_LIMIT = 1e-5


@pytest.mark.chip
@pytest.mark.parametrize("D", [512, 63])
def test_kernel_matches_float64_on_the_card(D: int, cuda_device: torch.device, monkeypatch) -> None:
    """2·16,384 + 1,234 rows (a ragged last chunk), at the default width (nine column tiles) and
    at D = 63, where β's column 2M = 128 opens a tile of its own. The IEEE float32 plain
    version is printed beside the kernel."""
    n = 2 * 16384 + 1234
    _, calls, _, _, _ = _fit_pass3("regression", n, D, d=28, pad_to=128, device=cuda_device, monkeypatch=monkeypatch)
    (args, kwargs, _), = calls
    args32 = [a.float().contiguous() for a in args]
    inv_c0 = float(kwargs["inv_c0"])
    ours = tpass3.fused_pass3(*args32, inv_c0=inv_c0)
    ref = tpass3.pass3_plain(*(a.double() for a in args32), inv_c0=inv_c0)
    ieee = tpass3.pass3_plain(*args32, inv_c0=inv_c0)
    sd = float(args32[3].double().std())
    scales = (sd, float(ref[1].abs().max()), sd)

    def errors(out: tuple) -> list[float]:
        return [float((a.double() - b).abs().max()) / scale for a, b, scale in zip(out, ref, scales)]

    print({"D": D, "kernel": errors(ours), "ieee_plain": errors(ieee)})
    assert all(e <= CARD_LIMIT for e in errors(ours)), errors(ours)


@pytest.mark.chip
def test_two_launches_give_the_same_bits(cuda_device: torch.device, monkeypatch) -> None:
    _, calls, _, _, _ = _fit_pass3("classification", 20000, 512, d=28, pad_to=128, device=cuda_device,
                                   monkeypatch=monkeypatch)
    (args, kwargs, _), = calls
    args32 = [a.float().contiguous() for a in args]
    first = tpass3.fused_pass3(*args32, inv_c0=float(kwargs["inv_c0"]))
    second = tpass3.fused_pass3(*args32, inv_c0=float(kwargs["inv_c0"]))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.chip
def test_float32_streaming_fits_launch_k3_once(cuda_device: torch.device, monkeypatch) -> None:
    """A float32 streaming fit on the card launches K3 once, on its path, and says so in its
    span; a float64 one runs the plain version. Two estimator fits of the same rows leave
    bit-identical ``residuals_`` and ``loo_ŷ_``."""
    monkeypatch.setattr(tpass3, "launches", 0)
    monkeypatch.setattr(tpass3, "path_launches", dict.fromkeys(tpass3.path_launches, 0))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for dtype in (torch.float32, torch.float64):
            _fit_pass3("regression", 20000, 64, pad_to=16384, dtype=dtype, device=cuda_device, monkeypatch=monkeypatch)
        torch.cuda.synchronize()
    paths = [r["attrs"]["path"] for r in profiling.spans() if r["name"] == "neo.solve.pass3"]
    profiling.clear_spans()
    assert paths == [_build.PATH_TF32, "plain"]
    assert tpass3.launches == 1 and tpass3.path_launches == {_build.PATH_TF32: 1}

    monkeypatch.setattr(estimator, "STREAMING_BYTES_THRESHOLD", 0)
    rows = _rows("classification", 40000, 28, 512, 9)
    X, y = rows["X"].astype(np.float32), rows["y"].astype(np.float32)
    fits = [NeoLSSVM(device=cuda_device).fit(X, y) for _ in range(2)]
    assert tpass3.path_launches == {_build.PATH_TF32: 3}
    for name in ("residuals_", "loo_ŷ_"):
        a, b = (np.asarray(getattr(m, name)) for m in fits)
        assert a.tobytes() == b.tobytes(), name
