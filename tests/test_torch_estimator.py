"""The port's ``NeoLSSVM(device="cpu")`` matches the JAX ``NeoLSSVM(pre_transform="host")``.

Both routes (in memory and streaming) for a regressor and a classifier, on the same
NumPy data. The streaming route is reached at a small size by lowering both packages'
``STREAMING_BYTES_THRESHOLD`` and ``STREAMING_ROW_CHUNK`` at test time. Also: a JAX
state dict carried across with ``from_jax_state_dict`` predicts what the JAX model
predicts, the estimator never runs on the CPU unless asked to, and what the port does not
cover yet raises ``NotImplementedError``.
"""

import numpy as np
import pytest
import torch

import neo_ls_svm_torch.models.estimator as t_est
import neo_ls_svm_tpu.models.estimator as j_est
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils.serialization import from_jax_state_dict
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures as JaxORFF

from .conftest import make_classification_dataset, make_regression_dataset

RTOL, ATOL = 1e-6, 1e-10
N = 1500


def _data(task: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    if task == "regression":
        X, y = make_regression_dataset(n=N + 300, seed=101)
    else:
        X, y = make_classification_dataset(n=N + 300, seed=101)
    return X[:N], y[:N], X[N:]


def _fit_pair(task: str) -> tuple[t_est.NeoLSSVM, j_est.NeoLSSVM, np.ndarray]:
    X, y, X_test = _data(task)
    ours = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=64), device="cpu").fit(X, y)
    theirs = j_est.NeoLSSVM(
        primal_feature_map=JaxORFF(num_features=64), pre_transform="host"
    ).fit(X, y)
    return ours, theirs, X_test


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_estimator_matches_jax(task: str, route: str, monkeypatch) -> None:
    if route == "streaming":
        for module in (t_est, j_est):
            monkeypatch.setattr(module, "STREAMING_BYTES_THRESHOLD", 0)
            monkeypatch.setattr(module, "STREAMING_ROW_CHUNK", 512)
    ours, theirs, X_test = _fit_pair(task)
    assert ours.γ_ == theirs.γ_
    assert ours.pre_transform_ == "host"
    np.testing.assert_allclose(ours.loo_score_, theirs.loo_score_, rtol=RTOL)
    for attr in ("loo_residuals_", "loo_std_", "loo_leverage_", "residuals_", "loo_errors_γs_"):
        np.testing.assert_allclose(
            getattr(ours, attr), getattr(theirs, attr), rtol=RTOL, atol=ATOL, err_msg=attr
        )
    if task == "classification":
        np.testing.assert_array_equal(ours.predict(X_test), theirs.predict(X_test))
    else:
        np.testing.assert_allclose(ours.predict(X_test), theirs.predict(X_test), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ours.decision_function(X_test), theirs.decision_function(X_test), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(ours.predict_std(X_test), theirs.predict_std(X_test), rtol=RTOL, atol=ATOL)
    assert ours.score(X_test[:50], theirs.predict(X_test[:50])) == pytest.approx(1.0)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_from_jax_state_dict_reproduces_predictions(task: str) -> None:
    X, y, X_test = _data(task)
    theirs = j_est.NeoLSSVM(
        primal_feature_map=JaxORFF(num_features=64), pre_transform="host"
    ).fit(X, y)
    ours = from_jax_state_dict(theirs.to_state_dict(), device="cpu")
    assert ours.γ_ == theirs.γ_
    assert type(ours.primal_feature_map_).__name__ == "OrthogonalRandomFourierFeatures"
    if task == "classification":
        np.testing.assert_array_equal(ours.predict(X_test), theirs.predict(X_test))
    np.testing.assert_allclose(
        ours.decision_function(X_test), theirs.decision_function(X_test), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(ours.predict_std(X_test), theirs.predict_std(X_test), rtol=1e-10, atol=1e-12)


def test_pandas_in_pandas_out() -> None:
    pd = pytest.importorskip("pandas")
    X, y, X_test = _data("regression")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu")
    model.fit(pd.DataFrame(X), pd.Series(y))
    index = pd.RangeIndex(7, 7 + len(X_test))
    for out in (model.predict(pd.DataFrame(X_test, index=index)), model.predict_std(pd.DataFrame(X_test, index=index))):
        assert isinstance(out, pd.Series)
        assert out.index.equals(index)


def test_fit_without_cpu_request_raises_when_cuda_is_unavailable() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device='cuda' is valid here")
    X, y, _ = _data("regression")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_est.NeoLSSVM().fit(X, y)


_NOT_PORTED = {
    "dual_auto": ({}, {"n": 500}),
    "dual_true": ({"dual": True}, {}),
    "pre_transform_device": ({"pre_transform": "device"}, {}),
    "transfer_int8": ({"transfer": "int8"}, {}),
    "mesh": ({"mesh": "auto"}, {}),
    "tensor_input": ({}, {"tensor": True}),
}


@pytest.mark.parametrize("case", sorted(_NOT_PORTED))
def test_fit_raises_for_what_is_not_ported(case: str) -> None:
    params, how = _NOT_PORTED[case]
    X, y, _ = _data("regression")
    X, y = X[: how.get("n", N)], y[: how.get("n", N)]
    if how.get("tensor"):
        X = torch.from_numpy(X)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_est.NeoLSSVM(device="cpu", **params).fit(X, y)


@pytest.mark.parametrize(
    "method", ["predict_proba", "predict_quantiles", "predict_interval", "predict_coverage"]
)
def test_serving_raises_for_what_is_not_ported(method: str) -> None:
    X, y, X_test = _data("classification")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    call = {
        "predict_proba": lambda: model.predict_proba(X_test),
        "predict_quantiles": lambda: model.predict_quantiles(X_test),
        "predict_interval": lambda: model.predict_interval(X_test),
        "predict_coverage": lambda: model.predict(X_test, coverage=0.9),
    }[method]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call()
