"""The in-memory solver (``models/primal.py::primal_fit``): its seams, its spans, and a fit of it
held to the benchmark's plain float64 reference (``perfbench/reference/lssvm.py``).

The seams, ``_sweep_in_memory`` (the γ-sweep) and ``_optimum_in_memory`` (the optimum's
statistics and the Cholesky re-solve), hold the computation that ``primal_fit`` once ran
inline: the same operations in the same order, so every result is bit-equal on the CPU to
that inline form, kept here as the test's reference. An in-memory fit records ``neo.solve``
(``route="inmemory"``) and its four steps under one ``neo.fit``; a streaming fit's spans keep
their names and gain the same two attributes.
"""

import numpy as np
import pytest
import torch

from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.models import estimator, routing
from neo_ls_svm_torch.models import primal as tp
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures
from neo_ls_svm_torch.utils import profiling
from neo_ls_svm_torch.utils.precision import SWEEP_MATMUL, matmul_precision
from perfbench.reference import lssvm

from .conftest import make_classification_dataset, make_regression_dataset
from .test_torch_spans import PARENT as STREAMING_PARENT

# Each span of an in-memory fit with the device pre-transform and the span open around it.
INMEMORY_PARENT = {
    **{name: parent for name, parent in STREAMING_PARENT.items() if not name.startswith("neo.solve.")},
    "neo.solve.gram": "neo.solve",
    "neo.solve.eigh": "neo.solve",
    "neo.solve.sweep": "neo.solve",
    "neo.solve.optimum": "neo.solve",
}
ROWS, COLUMNS, FEATURES = 2500, 5, 64


@matmul_precision("ieee")
def _inline_primal_fit(X, M_map, b_map, y, sample_weight, gammas, C_emb=None, *, is_classifier,
                       gamma_chunk=128, num_samples=None, row_sum=tp._identity, sweep_precision="high"):
    """``primal_fit`` as it ran before its seams: one body, the sweep and the optimum inline."""
    n = X.shape[0] if num_samples is None else num_samples
    dtype, device = X.dtype, X.device
    s = sample_weight / row_sum(torch.sum(sample_weight))
    s2 = s * s
    W = tp._features_real_pair(X, M_map, b_map)
    M2 = W.shape[1]
    M = M2 // 2
    inv_c0 = tp._inv_c0_scale(n, M, dtype, device)
    inv_c0_id = inv_c0
    B = row_sum(tp._embedding_gram(W, s2))
    sign = tp._sign_vector(M, dtype, device)
    lam, Qs, inv_c0 = tp._eigendecompose(B, C_emb, inv_c0, sign)
    Gu = W @ Qs
    b_vec = row_sum(W.T @ (s2 * y))
    k = Qs.T @ b_vec
    Gu2 = Gu * Gu
    Gu_k = Gu * k[None, :]
    s2_col = s2[:, None]
    loo_err_parts, obj_parts = [], []
    for start in range(0, gammas.shape[0], gamma_chunk):
        r = 1.0 / (gammas[None, start : start + gamma_chunk] + lam[:, None])
        with matmul_precision(SWEEP_MATMUL[sweep_precision]):
            num = inv_c0 * (Gu_k @ r)
            lev = inv_c0 * s2_col * (Gu2 @ r)
        e = (num - y[:, None]) / (1.0 - lev)
        e = tp._clip_classifier_residuals(e, y, is_classifier)
        loo_err_c, obj_c = tp._sweep_objective(e, s, is_classifier)
        loo_err_parts.append(loo_err_c)
        obj_parts.append(obj_c)
    loo_errors_gs, objective = row_sum(torch.stack([torch.cat(loo_err_parts), torch.cat(obj_parts)]))
    optimum = torch.argmin(objective)
    gamma_opt = gammas[optimum]
    r_opt = 1.0 / (gamma_opt + lam)
    sigma2 = inv_c0 * (Gu2 @ r_opt)
    phi_beta_opt = inv_c0 * (Gu_k @ r_opt)
    lev_opt = s2 * sigma2
    e_raw = (phi_beta_opt - y) / (1.0 - lev_opt)
    e_clipped = tp._clip_classifier_residuals(e_raw, y, is_classifier)
    loo_score = tp._loo_score(y, s, e_raw, is_classifier, row_sum)
    L = torch.linalg.cholesky(tp._regularised_gram(B, C_emb, gamma_opt, inv_c0_id))
    beta_emb = torch.cholesky_solve((sign * b_vec)[:, None], L)[:, 0]
    residuals = tp._clip_classifier_residuals(W @ (sign * beta_emb) - y, y, is_classifier)
    loo_sigma2 = sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)
    return {
        "beta_emb": beta_emb, "gamma": gamma_opt, "optimum_index": optimum, "lam": lam, "Qs": Qs,
        "loo_errors_gammas": loo_errors_gs, "loo_residuals": e_clipped, "loo_yhat": y + e_clipped,
        "loo_leverage": lev_opt, "loo_error": loo_errors_gs[optimum], "loo_score": loo_score,
        "loo_std": torch.sqrt(loo_sigma2), "residuals": residuals,
    }


def _operands(task: str, dtype: torch.dtype, n: int = 700, seed: int = 5) -> tuple[bool, list[torch.Tensor]]:
    if task == "regression":
        X, y = make_regression_dataset(n=n, d=5, seed=seed)
    else:
        X, labels = make_classification_dataset(n=n, d=5, seed=seed)
        y = np.where(labels == "pos", 1.0, -1.0)
    s = np.random.RandomState(seed + 1).rand(n) + 0.25
    M_map, b_map = OrthogonalRandomFourierFeatures(num_features=24).fit(X, y, s).linear_map()
    arrays = (X, M_map, b_map, y, s, tp.gamma_grid(np.float64))
    return task == "classification", [torch.from_numpy(np.asarray(a, np.float64)).to(dtype) for a in arrays]


def _complexity(M: int, dtype: torch.dtype) -> torch.Tensor:
    """A normalised complexity matrix in the real embedding other than c₀·I: the GEVD path."""
    C = torch.diag(torch.linspace(0.5, 2.0, M, dtype=torch.float64)) / (700 * M)
    zeros = torch.zeros_like(C)
    return torch.cat([torch.cat([C, zeros], 1), torch.cat([zeros, C], 1)], 0).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    ("task", "options"),
    [
        ("regression", {}),
        ("classification", {}),
        ("regression", {"gamma_chunk": 100, "num_samples": 650}),
        ("classification", {"sweep_precision": "fast"}),
        ("regression", {"complexity": True}),
    ],
    ids=["regression", "classification", "uneven_chunks", "fast", "gevd"],
)
def test_the_seams_are_bit_equal_to_the_inline_computation(task, options, dtype):
    is_classifier, operands = _operands(task, dtype)
    options = dict(options)
    if options.pop("complexity", False):
        operands.append(_complexity(operands[1].shape[1] + 1, dtype))
    ours = tp.primal_fit(*operands, is_classifier=is_classifier, **options)
    inline = _inline_primal_fit(*operands, is_classifier=is_classifier, **options)
    assert list(ours) == list(inline)
    for key, value in inline.items():
        assert ours[key].dtype == value.dtype and torch.equal(ours[key], value), key


def test_the_float32_gram_is_the_float64_sum_rounded_once():
    # 70,000 rows (three blocks of the sum), a bias column and alike weights: the terms whose
    # float32 sum over the rows loses the most. Each entry of the embedding is float64's,
    # rounded once to float32 (half an ulp, 2⁻²⁴ of it).
    gen = torch.Generator().manual_seed(2)
    n, M = 70000, 9
    U = 3.0 * torch.randn((n, M - 1), generator=gen, dtype=torch.float64)
    ones, zeros = torch.ones((n, 1), dtype=torch.float64), torch.zeros((n, 1), dtype=torch.float64)
    W = torch.cat([torch.cos(U), ones, torch.sin(U), zeros], dim=1).float()
    s2 = torch.full((n,), 1.0 / n**2, dtype=torch.float32)
    assert n > 2 * tp.GRAM_ROW_BLOCK
    B = tp._embedding_gram(W, s2)
    B64 = tp.embed_from_gram_blocks((W.double().T * s2.double()[None, :]) @ W.double(), M)
    assert B.dtype == torch.float32
    assert torch.all((B.double() - B64).abs() <= 2.0**-24 * B64.abs())


def _data(dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    gen = np.random.RandomState(3)
    X = gen.randn(ROWS, COLUMNS).astype(dtype)
    return X, (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * gen.randn(ROWS)).astype(dtype)


def _traced_fit(mp: pytest.MonkeyPatch, *, stream: bool) -> tuple[NeoLSSVM, list[dict]]:
    """One fit of the device pre-transform's route, recorded under a profiler."""
    mp.setattr(routing, "AUTO_DEVICE_PT_MIN_BYTES", 0)
    if stream:
        mp.setattr(estimator, "STREAMING_BYTES_THRESHOLD", 0)
        mp.setattr(estimator, "STREAMING_ROW_CHUNK", 1024)
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        features = OrthogonalRandomFourierFeatures(num_features=FEATURES)
        model = NeoLSSVM(device="cpu", random_state=7, primal_feature_map=features).fit(*_data())
    return model, profiling.spans()


def test_an_inmemory_fit_records_its_route_and_four_steps_under_one_root(monkeypatch):
    model, records = _traced_fit(monkeypatch, stream=False)
    by_name = {r["name"]: r for r in records}
    assert model.pre_transform_ == "device"
    assert sorted(r["name"] for r in records) == sorted(INMEMORY_PARENT)
    assert {r["root"] for r in records} == {by_name["neo.fit"]["id"]}
    for name, parent in INMEMORY_PARENT.items():
        if parent is not None:
            assert by_name[name]["parent"] == by_name[parent]["id"], name
    steps = [by_name[f"neo.solve.{step}"] for step in ("gram", "eigh", "sweep", "optimum")]
    for earlier, later in zip(steps, steps[1:]):
        assert earlier["t1_ns"] <= later["t0_ns"]
    assert by_name["neo.solve"]["attrs"] == {
        "route": "inmemory",
        "working_set_bytes": estimator._primal_working_set_bytes(ROWS, FEATURES, 4),
    }
    assert by_name["neo.solve.sweep"]["attrs"] == {"gamma_chunks": 8}


def test_a_streaming_fit_keeps_its_span_names_and_gains_the_two_attributes(monkeypatch):
    _, records = _traced_fit(monkeypatch, stream=True)
    assert sorted(r["name"] for r in records) == sorted(STREAMING_PARENT)
    (solve,) = [r for r in records if r["name"] == "neo.solve"]
    working_set = estimator._primal_working_set_bytes(ROWS, FEATURES, 4)
    assert solve["attrs"] == {"route": "streaming", "working_set_bytes": working_set}


# How far an in-memory float32 fit may lie from the float64 reference on the same M and b, on
# 4,000 rows with 64 features (M₂ = 130) and a noisy target, so that the chosen γ lies inside the
# grid. Float32 rounds the eigenbasis, the sweep and the re-solve at ε = 6e-8 of their largest
# entries (the Gram is summed in float64); the re-solve grows that by the condition number κ of
# B + γ/c₀⁻¹·I at the chosen γ, which the test bounds (read 5.2e4 and 1.5e5), and the LOO
# residual by 1/(1 − h) besides.
KAPPA = 5e5
# ‖Δβ‖/‖β‖, under the κ·ε of 3e-3 to 9e-3 that a float32 re-solve may reach: read 1.1e-4 and 1.2e-4.
BETA_RTOL = 1e-3
LOO_RESIDUAL_ATOL = 1e-2  # max |Δe| over the target's sd, the same growth: read 8.9e-4 and 1.7e-3
LOO_ERROR_RTOL = 1e-4  # each γ's weighted sum of |e| over 4,000 rows, relative: read 3.0e-6 and 6.0e-6
# The objective is flat near its minimum, and a classifier's counts the rows whose |LOO
# residual| reaches 1, so rounding that moves one row of 4,000 across 1 moves it by 2.5e-4: the
# chosen γ may lie on a neighbouring index (read 443 against 442, 355 against 316). The
# reference's objective there over its minimum, relative: read 1.0e-7 and 2.6e-4.
OBJECTIVE_GAP = 2e-3


def _noisy_data() -> tuple[np.ndarray, np.ndarray]:
    gen = np.random.RandomState(3)
    X = gen.randn(4000, COLUMNS).astype(np.float32)
    return X, (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + gen.randn(4000)).astype(np.float32)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_an_inmemory_float32_fit_agrees_with_the_float64_reference(task):
    X, y = _noisy_data()
    is_classifier = task == "classification"
    if is_classifier:
        y = (y > 0).astype(np.int64)
    features = OrthogonalRandomFourierFeatures(num_features=64)
    model = NeoLSSVM(device="cpu", random_state=11, primal_feature_map=features).fit(X, y)
    assert model.primal_ and model._estimator_type == ("classifier" if is_classifier else "regressor")
    y_signed = lssvm.signed_target(y, is_classifier, np.float64)
    gammas = np.asarray(model.γs_, np.float64)
    ref = lssvm.Fit(X, y_signed, model._M_map, model._b_map, gammas, is_classifier=is_classifier, mode="f64",
                    device=torch.device("cpu"), block=1024)
    operands = ref.operands()
    objective = ref.sweep(operands)["objective"]
    index = int(np.argmin(np.abs(gammas - model.γ_)))
    assert (objective[index] - objective.min()) / objective.min() <= OBJECTIVE_GAP
    eye = torch.eye(ref.B.shape[0], dtype=torch.float64)
    assert torch.linalg.cond(ref.B + (ref.gammas[index] / ref.inv_c0) * eye) <= KAPPA
    swept = ref.sweep(operands, index)
    loo_error = np.asarray(model.loo_errors_γs_, np.float64)
    assert np.max(np.abs(loo_error - swept["loo_error"]) / swept["loo_error"]) <= LOO_ERROR_RTOL
    beta_r = ref.beta(index)
    assert np.linalg.norm(model.beta_emb_ - beta_r) / np.linalg.norm(beta_r) <= BETA_RTOL
    e_r = swept["loo_yhat"] - y_signed
    assert np.max(np.abs(np.asarray(model.loo_residuals_, np.float64) - e_r)) / np.std(y_signed) <= LOO_RESIDUAL_ATOL
