"""``precision="fast"`` and the scope of the port's float32 product precision, on the CPU.

* The fast contract of the JAX package's own tests (``tests/test_estimator.py:322-358``,
  which hold the JAX package to it), on the port with the same float32 data: with the
  streaming route forced, the LOO score within 0.01 of "high", γ near-optimal under the
  "high" LOO error at rel 1e-3 and predictions within 0.02·std(y); in memory, the LOO
  score within 0.005 and γ near-optimal.
* The port against the JAX package under "fast", in float64 at the estimator tests' rtol
  1e-6. On the CPU every product is IEEE, so the port's "fast" also equals its "high" bit
  for bit.
* The plumbing: "fast" reaches K2 as ``precision="fast"`` on the streaming routes, and only
  the in-memory sweep's two contractions (or, streaming on the CPU, the plain sweep's three
  products) run under TF32; every other product of a fit runs under IEEE.
* The scope: ``fit``, the serving entries and restored models leave
  ``torch.backends.cuda.matmul`` as the caller set it, through the legacy
  (``allow_tf32 = True``) and the new (``fp32_precision = "tf32"``) API, and the caller
  reads its own flag back without an error.
"""

import pickle

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import neo_ls_svm_torch.models.estimator as t_est
import neo_ls_svm_torch.models.primal as t_primal
import neo_ls_svm_tpu.models.estimator as j_est
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures as JaxORFF

from .conftest import make_classification_dataset, make_regression_dataset

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-10


def _gamma_near_optimal(fast, high, rel: float = 1e-3) -> bool:
    """The fast fit's γ is near-optimal under the high fit's LOO error (the JAX package's
    gate: the objective is flat near its minimum, so the grid index is no gate)."""
    idx = int(np.argmin(np.abs(high.γs_ - fast.γ_)))
    return float(high.loo_errors_γs_[idx]) <= float(np.min(high.loo_errors_γs_)) * (1.0 + rel)


def _force_streaming(monkeypatch, row_chunk: int = 512) -> None:
    for module in (t_est, j_est):
        monkeypatch.setattr(module, "STREAMING_BYTES_THRESHOLD", 1)
    monkeypatch.setattr(t_est, "STREAMING_ROW_CHUNK", row_chunk)


@pytest.mark.parametrize("route", ["streaming", "inmemory"])
def test_fast_precision_contract(route: str, monkeypatch) -> None:
    X, y = make_regression_dataset(n=2048, seed=103 if route == "streaming" else 104)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    high = t_est.NeoLSSVM(precision="high", device="cpu").fit(X32, y32)  # in memory, as in JAX's test
    if route == "streaming":
        _force_streaming(monkeypatch)
    fast = t_est.NeoLSSVM(precision="fast", device="cpu").fit(X32, y32)
    assert _gamma_near_optimal(fast, high)
    if route == "streaming":
        assert abs(fast.loo_score_ - high.loo_score_) < 0.01
        pred_fast, pred_high = fast.predict(X32[:256]), high.predict(X32[:256])
        assert np.max(np.abs(pred_fast - pred_high)) < 0.02 * np.std(y32)
    else:
        assert abs(fast.loo_score_ - high.loo_score_) < 0.005


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_fast_matches_jax_and_high(task: str, route: str, monkeypatch) -> None:
    make = make_regression_dataset if task == "regression" else make_classification_dataset
    X, y = make(n=1800, seed=105)
    X, y, X_test = X[:1500], y[:1500], X[1500:]
    if route == "streaming":
        _force_streaming(monkeypatch)
        monkeypatch.setattr(j_est, "STREAMING_ROW_CHUNK", 512)
    ours, high = (
        t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=64), precision=p, device="cpu").fit(X, y)
        for p in ("fast", "high")
    )
    theirs = j_est.NeoLSSVM(
        primal_feature_map=JaxORFF(num_features=64), pre_transform="host", precision="fast"
    ).fit(X, y)
    assert ours.γ_ == theirs.γ_
    np.testing.assert_allclose(ours.loo_score_, theirs.loo_score_, rtol=RTOL)
    for attr in ("loo_residuals_", "loo_std_", "loo_leverage_", "residuals_", "loo_errors_γs_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(theirs, attr), rtol=RTOL, atol=ATOL, err_msg=attr)
        np.testing.assert_array_equal(getattr(ours, attr), getattr(high, attr), err_msg=attr)
    np.testing.assert_allclose(
        ours.decision_function(X_test), theirs.decision_function(X_test), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("pre_transform", ["host", "device"])
def test_fast_reaches_k2_on_the_streaming_routes(pre_transform: str, monkeypatch) -> None:
    """The estimator maps precision to K2's ``precision`` on both streaming routes, as
    the JAX estimator maps it to ``sweep_precision`` (its ``:538-540`` and ``:831``)."""
    seen = []
    real = t_primal.fused_loo_sweep

    def recorder(*args, **kwargs):
        seen.append(kwargs["precision"])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_primal, "fused_loo_sweep", recorder)
    _force_streaming(monkeypatch)
    X, y = make_regression_dataset(n=1500, seed=106)
    for precision in ("fast", "high"):
        t_est.NeoLSSVM(
            primal_feature_map=TorchORFF(num_features=32), precision=precision, pre_transform=pre_transform, device="cpu"
        ).fit(X, y)
    assert seen == ["fast", "high"]


class _Products(TorchFunctionMode):
    """Records every matrix product: its operands' shapes and the CUDA fp32 precision in
    force when it ran."""

    PRODUCTS = (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.matmul,
                torch.mm, torch.Tensor.mm, torch.bmm, torch.mv)

    def __init__(self) -> None:
        super().__init__()
        self.seen: list[tuple] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            a, b = args[:2]
            self.seen.append((tuple(a.shape), tuple(b.shape), torch.backends.cuda.matmul.fp32_precision))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
@pytest.mark.parametrize("precision", ["fast", "high"])
def test_only_the_sweep_products_run_in_tf32(route: str, precision: str, monkeypatch) -> None:
    """Under "fast", in memory only the two contractions (Gu∘k)·r and (Gu∘Gu)·r of every
    γ chunk enter the TF32 scope; streaming, on the CPU, only the plain sweep's Gu, num and
    lev products of every row chunk (on the card, K2 takes the one pass itself). Every
    other product of the fit runs under IEEE, and under "high" every product does."""
    if route == "streaming":
        _force_streaming(monkeypatch)
    n, D = 1500, 32
    X, y = make_regression_dataset(n=n, seed=107)
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=D), precision=precision, device="cpu")
    with _Products() as products:
        model.fit(X, y)
    M2, G = 2 * D + 2, len(model.γs_)
    assert {flag for *_, flag in products.seen} <= {"ieee", "tf32"}
    tf32 = [(a, b) for a, b, flag in products.seen if flag == "tf32"]
    if precision == "high":
        assert tf32 == []
    elif route == "inmemory":
        assert tf32 == [((n, M2), (M2, 128))] * (2 * G // 128)
    else:
        rows = -(-n // 512) * 512
        assert tf32 == [((rows, M2), (M2, M2)), ((rows, M2), (M2, G)), ((rows, M2), (M2, G))]


@pytest.fixture
def caller_precision():
    """Restores the process's CUDA fp32 precision after a test that sets it as a caller."""
    saved = torch.backends.cuda.matmul.fp32_precision
    yield
    torch.backends.cuda.matmul.fp32_precision = saved


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_entries_leave_the_callers_tf32_setting(api: str, caller_precision) -> None:
    matmul = torch.backends.cuda.matmul
    if api == "legacy":
        matmul.allow_tf32 = True
    else:
        matmul.fp32_precision = "tf32"

    def caller_reads_its_setting() -> None:
        if api == "legacy":
            assert matmul.allow_tf32 is True
        else:
            assert matmul.fp32_precision == "tf32"

    X, y = make_regression_dataset(n=1600, seed=108)
    X, y, X_test = X[:1500], y[:1500], X[1500:]
    for precision in ("high", "fast"):
        model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), precision=precision, device="cpu")
        model.fit(X, y)
        caller_reads_its_setting()
    calls = (
        lambda m: m.predict_std(X_test),
        lambda m: m.decision_function(X_test),
        lambda m: m.predict_interval(X_test, coverage=0.9),
    )
    for call in calls:  # the conformal levels are fitted here, then carried by the restores
        call(model)
        caller_reads_its_setting()
    restored = (
        pickle.loads(pickle.dumps(model)),
        t_est.NeoLSSVM.from_state_dict(model.to_state_dict(), device="cpu"),
    )
    for m in restored:
        for call in calls:
            call(m)
            caller_reads_its_setting()


def test_scope_restores_the_setting_on_error(caller_precision) -> None:
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    with pytest.raises(ZeroDivisionError), matmul_precision("ieee"):
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
        _ = 1 / 0
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"


def test_solver_rejects_an_unknown_sweep_precision() -> None:
    X = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="sweep_precision"):
        t_primal.primal_fit(X, X, X[:1], X[:, 0], X[:, 0], X[0], is_classifier=False, sweep_precision="DEFAULT")
