"""The port's ``NeoLSSVM(device="cpu")`` matches the JAX ``NeoLSSVM``.

With the host pre-transform, both primal routes (in memory and streaming) and the dual
route, for a regressor and a classifier, on the same NumPy data at rtol 1e-6. The streaming
route is reached at a small size by lowering both packages' ``STREAMING_BYTES_THRESHOLD``
and ``STREAMING_ROW_CHUNK`` at test time. With the device pre-transform the two packages
draw from different generators, so their scores are held within 0.015 of each other and of
the host route (the gate of the JAX package's own tests), and the narrow ``transfer`` modes
within 0.03 LOO R². ``pre_transform_`` and ``transfer_`` equal the JAX package's on every
call made here. Also: a JAX state dict carried across with ``from_jax_state_dict`` predicts
what the JAX model predicts, the estimator never runs on the CPU unless asked to, what the
port does not cover yet raises ``NotImplementedError``, and the calibrated serving entries
(``predict_proba``, ``predict_quantiles``, ``predict_interval``, ``predict(coverage=…)``)
answer what the JAX model answers at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import neo_ls_svm_torch.models.estimator as t_est
import neo_ls_svm_torch.models.routing as t_routing
import neo_ls_svm_tpu.models.estimator as j_est
import neo_ls_svm_tpu.models.routing as j_routing
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils.serialization import from_jax_state_dict
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures as JaxORFF

from .conftest import make_classification_dataset, make_regression_dataset

# The suite runs several worker processes on a few cores: more intra-op threads than that
# only contend (these shapes are small).
torch.set_num_threads(2)

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


def test_fit_raises_for_what_is_not_ported() -> None:
    """Every option of the JAX estimator is ported (``mesh=`` last); a value that neither
    package takes raises ValueError naming the option."""
    X, y, _ = _data("regression")
    for option, value in (("mesh", "all-devices"), ("pre_transform", "gpu"), ("transfer", "float16")):
        with pytest.raises(ValueError, match=option):
            t_est.NeoLSSVM(device="cpu", **{option: value}).fit(X, y)


def test_fit_takes_a_tensor_on_the_models_device() -> None:
    """A tensor X takes the device pre-transform and fits what the same NumPy rows fit."""
    X, y, X_test = _data("regression")
    params = {"primal_feature_map": TorchORFF(num_features=32), "device": "cpu"}
    from_tensor = t_est.NeoLSSVM(**params).fit(torch.from_numpy(X), y)
    from_numpy = t_est.NeoLSSVM(pre_transform="device", **params).fit(X, y)
    assert from_tensor.pre_transform_ == "device"
    assert from_tensor.γ_ == from_numpy.γ_
    np.testing.assert_array_equal(from_tensor.predict(X_test), from_numpy.predict(X_test))


_SERVING = {
    "predict_proba": lambda m, X: m.predict_proba(X),
    "predict_quantiles": lambda m, X: m.predict_quantiles(X),
    "predict_interval": lambda m, X: m.predict_interval(X),
    "predict_coverage": lambda m, X: m.predict(X, coverage=0.9),
}


@pytest.mark.parametrize("method", sorted(_SERVING))
def test_serving_entries_match_jax(method: str) -> None:
    """Each calibrated serving entry of a classifier against the JAX model's host lane, at
    rtol 1e-6 (the fits agree at 1e-6, the LPs are the same LPs)."""
    X, y, X_test = _data("classification")
    ours = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    theirs = j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=16), pre_transform="host").fit(X, y)
    out = _SERVING[method](ours, X_test)
    assert out.shape == ((len(X_test), 2) if method == "predict_proba" else (len(X_test), out.shape[1], 2))
    np.testing.assert_allclose(out, _SERVING[method](theirs, X_test), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------------ the dual route

_DUAL = {"auto_n500": ({}, 500), "dual_true_n1100": ({"dual": True}, 1100)}


@pytest.mark.parametrize("how", sorted(_DUAL))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_dual_estimator_matches_jax(task: str, how: str) -> None:
    params, n = _DUAL[how]
    X, y, X_test = _data(task)
    w = np.random.RandomState(5).rand(n) + 0.25
    w[:7] = 0.0  # the dual route drops zero-weight rows
    ours = t_est.NeoLSSVM(device="cpu", **params).fit(X[:n], y[:n], sample_weight=w)
    theirs = j_est.NeoLSSVM(**params).fit(X[:n], y[:n], sample_weight=w)
    assert ours.dual_ and not ours.primal_
    assert (ours.pre_transform_, ours.transfer_) == (theirs.pre_transform_, theirs.transfer_) == ("host", "float32")
    np.testing.assert_array_equal(ours.X_, theirs.X_)  # the host pre-transform is bit-equal
    assert ours.X_.shape[0] == n - 7
    assert ours.γ_ == theirs.γ_
    for attr in ("α̂_", "loo_residuals_", "loo_std_", "residuals_", "loo_errors_γs_", "loo_score_"):
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


def test_dual_route_keeps_the_host_pre_transform() -> None:
    X, y, X_test = _data("regression")
    host = t_est.NeoLSSVM(device="cpu").fit(X[:700], y[:700])
    asked = t_est.NeoLSSVM(device="cpu", pre_transform="device").fit(X[:700], y[:700])
    assert asked.pre_transform_ == "host"
    np.testing.assert_array_equal(asked.predict(X_test), host.predict(X_test))


def test_refit_on_another_route_leaves_no_stale_state() -> None:
    X, y, X_test = _data("regression")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu").fit(X, y)
    assert model.primal_ and hasattr(model, "beta_emb_")
    model.fit(X[:400], y[:400])
    assert model.dual_ and not hasattr(model, "beta_emb_") and not hasattr(model, "primal_feature_map_")
    fresh = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu").fit(X[:400], y[:400])
    np.testing.assert_array_equal(model.predict(X_test), fresh.predict(X_test))
    model.fit(X, y)
    assert model.primal_ and not hasattr(model, "X_") and not hasattr(model, "α̂_")


# ----------------------------------------------------- the device pre-transform

N_PT = 3000


def _pt_data(task: str) -> tuple[np.ndarray, np.ndarray]:
    if task == "regression":
        return make_regression_dataset(n=N_PT + 1000, seed=31)
    return make_classification_dataset(n=N_PT + 1000, seed=32)


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_device_route_scores_match_host_and_jax(task: str, route: str, monkeypatch) -> None:
    if route == "streaming":
        for module in (t_est, j_est):
            monkeypatch.setattr(module, "STREAMING_BYTES_THRESHOLD", 0)
            monkeypatch.setattr(module, "STREAMING_ROW_CHUNK", 1024)  # 3000 rows → 72 padding rows
    X, y = _pt_data(task)
    X_tr, y_tr, X_te, y_te = X[:N_PT], y[:N_PT], X[N_PT:], y[N_PT:]
    host = t_est.NeoLSSVM(device="cpu", pre_transform="host").fit(X_tr, y_tr)
    ours = t_est.NeoLSSVM(device="cpu", pre_transform="device").fit(X_tr, y_tr)
    theirs = j_est.NeoLSSVM(pre_transform="device").fit(X_tr, y_tr)
    assert ours.pre_transform_ == theirs.pre_transform_ == "device"
    assert ours.transfer_ == theirs.transfer_ == "float32"
    assert host.pre_transform_ == "host"
    assert ours.loo_residuals_.shape == (N_PT,)
    for other in (host, theirs):
        assert abs(ours.score(X_te, y_te) - other.score(X_te, y_te)) < 0.015
        assert abs(ours.loo_score_ - other.loo_score_) < 0.015
    # The state written back to the host feature map is the map the solver used:
    # (X − shift)/scale · A_ == X·M + b.
    affine = ours.primal_feature_map_.affine_feature_map
    U_affine = ((X_te[:10] - affine.shift_) / affine.scale_) @ affine.A_
    np.testing.assert_allclose(U_affine, X_te[:10] @ ours._M_map + ours._b_map, rtol=1e-8, atol=1e-10)
    fm = ours.primal_feature_map_
    np.testing.assert_allclose(fm.prefold_A_ @ fm.Z_, fm.folded_A_, rtol=1e-10, atol=1e-12)
    phi = fm.transform(X_te[:10])
    assert phi.shape == (10, fm.num_features + 1)
    np.testing.assert_allclose(np.abs(phi[:, :-1]), 1 / np.sqrt(fm.num_features), rtol=1e-9)


def _custom_complexity(base: type) -> type:
    class CustomComplexityORFF(base):
        @property
        def complexity_matrix(self):
            return np.diag(np.linspace(1.0, 2.0, self.num_features + 1)).astype(self.Z_.dtype)

    return CustomComplexityORFF


_AUTO = {
    "below_the_threshold": ({}, None, False, "host"),
    "threshold_0": ({}, 0, False, "device"),
    "payload_equal_to_the_threshold": ({}, N * 8 * 8, False, "device"),
    "custom_complexity_matrix": ({}, 0, True, "host"),
    "device_asked_custom_complexity_matrix": ({"pre_transform": "device"}, None, True, "host"),
    "host_asked_above_the_threshold": ({"pre_transform": "host"}, 0, False, "host"),
}


@pytest.mark.parametrize("case", sorted(_AUTO))
def test_pre_transform_resolves_as_in_jax(case: str, monkeypatch) -> None:
    params, threshold, custom, expected = _AUTO[case]
    if threshold is not None:
        monkeypatch.setattr(t_routing, "AUTO_DEVICE_PT_MIN_BYTES", threshold)
        monkeypatch.setattr(j_routing, "AUTO_DEVICE_PT_MIN_BYTES", threshold)
    X, y, _ = _data("regression")
    t_map = (_custom_complexity(TorchORFF) if custom else TorchORFF)(num_features=32)
    j_map = (_custom_complexity(JaxORFF) if custom else JaxORFF)(num_features=32)
    ours = t_est.NeoLSSVM(primal_feature_map=t_map, device="cpu", **params).fit(X, y)
    theirs = j_est.NeoLSSVM(primal_feature_map=j_map, **params).fit(X, y)
    assert ours.pre_transform_ == theirs.pre_transform_ == expected
    assert ours.transfer_ == theirs.transfer_ == "float32"
    if expected == "host":
        np.testing.assert_allclose(ours.loo_residuals_, theirs.loo_residuals_, rtol=RTOL, atol=ATOL)


def test_routing_threshold_equals_the_jax_package() -> None:
    assert t_routing.AUTO_DEVICE_PT_MIN_BYTES == j_routing.AUTO_DEVICE_PT_MIN_BYTES == 32 * 1024**2
    for pre_transform in ("auto", "host", "device"):
        for transfer in ("auto", "float32", "bfloat16", "int8"):
            for payload in (0, 32 * 1024**2 - 1, 32 * 1024**2, 1 << 30):
                for eligible in (False, True):
                    kw = {"payload_bytes": payload, "device_pt_eligible": eligible}
                    assert t_routing._resolve_fit_plan(pre_transform, transfer, **kw) == j_routing._resolve_fit_plan(
                        pre_transform, transfer, **kw, tunneled=False
                    )


_TRANSFER_ERRORS = {
    "bfloat16_with_host": ({"transfer": "bfloat16", "pre_transform": "host"}, N, False, "bfloat16"),
    "int8_with_host": ({"transfer": "int8", "pre_transform": "host"}, N, False, "int8"),
    "bfloat16_below_the_threshold": ({"transfer": "bfloat16"}, N, False, "bfloat16"),
    "unknown_transfer": ({"transfer": "fp8", "pre_transform": "device"}, N, False, "transfer"),
    "unknown_pre_transform": ({"pre_transform": "gpu"}, N, False, "pre_transform"),
    "int8_on_the_dual_route": ({"transfer": "int8", "pre_transform": "device"}, 700, False, "dual"),
    "bfloat16_custom_complexity_matrix": ({"transfer": "bfloat16", "pre_transform": "device"}, N, True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_TRANSFER_ERRORS))
def test_transfer_and_pre_transform_value_errors_as_in_jax(case: str) -> None:
    params, n, custom, match = _TRANSFER_ERRORS[case]
    X, y, _ = _data("regression")
    t_map = (_custom_complexity(TorchORFF) if custom else TorchORFF)(num_features=32)
    j_map = (_custom_complexity(JaxORFF) if custom else JaxORFF)(num_features=32)
    with pytest.raises(ValueError, match=match):
        j_est.NeoLSSVM(primal_feature_map=j_map, **params).fit(X[:n], y[:n])
    with pytest.raises(ValueError, match=match):
        t_est.NeoLSSVM(primal_feature_map=t_map, device="cpu", **params).fit(X[:n], y[:n])


@pytest.mark.parametrize("transfer", ["bfloat16", "int8"])
def test_narrow_transfer_fits_within_noise(transfer: str) -> None:
    X, y = _pt_data("regression")
    X_tr, y_tr, X_te, y_te = X[:N_PT], y[:N_PT], X[N_PT:], y[N_PT:]
    t_map, j_map = TorchORFF(num_features=128), JaxORFF(num_features=128)
    full = t_est.NeoLSSVM(primal_feature_map=t_map, device="cpu", pre_transform="device").fit(X_tr, y_tr)
    lossy = t_est.NeoLSSVM(
        primal_feature_map=t_map, device="cpu", pre_transform="device", transfer=transfer
    ).fit(X_tr, y_tr)
    theirs = j_est.NeoLSSVM(primal_feature_map=j_map, pre_transform="device", transfer=transfer).fit(
        X_tr[:1500], y_tr[:1500]
    )
    assert (lossy.pre_transform_, lossy.transfer_) == (theirs.pre_transform_, theirs.transfer_) == ("device", transfer)
    assert abs(full.loo_score_ - lossy.loo_score_) < 0.03
    assert abs(full.score(X_te, y_te) - lossy.score(X_te, y_te)) < 0.03
    # Serving uploads at the model's width: predictions track the full-width ones.
    lossy_pred = lossy.predict(X_te)
    lossy.transfer_ = "float32"
    err = np.abs(lossy_pred - lossy.predict(X_te))
    assert 0 < np.median(err) < 0.05 * (np.quantile(y, 0.75) - np.quantile(y, 0.25))


def test_upload_rows_narrows_as_the_jax_package_does() -> None:
    import ml_dtypes

    from neo_ls_svm_torch.utils.transfer import symmetric_int8_grid, upload_rows
    from neo_ls_svm_tpu.utils.transfer import symmetric_int8_grid as j_grid

    chunk = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    chunk[:, 3] = 0.0  # a zero column takes scale 1
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(upload_rows(chunk, "float32", cpu).numpy(), chunk)
    np.testing.assert_array_equal(
        upload_rows(chunk, "bfloat16", cpu).numpy(), chunk.astype(ml_dtypes.bfloat16).astype(np.float32)
    )
    scale, cast_fn = symmetric_int8_grid(chunk)
    j_scale, j_cast_fn = j_grid(chunk)
    np.testing.assert_array_equal(scale, j_scale)
    np.testing.assert_array_equal(cast_fn(chunk), j_cast_fn(chunk))
    up = upload_rows(chunk, "int8", cpu)
    assert up.dtype == torch.float32
    np.testing.assert_array_equal(up.numpy(), cast_fn(chunk).astype(np.float32) * scale[None, :])
    assert upload_rows(chunk.astype(np.float64), "int8", cpu).dtype == torch.float64


def test_int8_grid_ignores_zero_weight_rows() -> None:
    """An absurd-valued zero-weight row must not stretch the quantisation grid (it would
    quantise every real row to zero)."""
    X, y = make_regression_dataset(n=2500, seed=49)
    X_poison = X.copy()
    X_poison[0] = 1e6
    w = np.ones_like(y)
    w[0] = 0.0
    model = t_est.NeoLSSVM(device="cpu", pre_transform="device", transfer="int8").fit(X_poison, y, sample_weight=w)
    assert model.score(X[1:], y[1:]) > 0.8


def test_near_constant_target_degrades_to_the_identity_metric() -> None:
    gen = np.random.RandomState(36)
    X = gen.randn(2000, 4)
    y = np.zeros(2000)
    y[:10] = np.arange(10, dtype=float) + 1  # more than 2 unique values → regressor
    model = t_est.NeoLSSVM(device="cpu", pre_transform="device").fit(X, y)
    assert np.isfinite(model.loo_score_)
    np.testing.assert_allclose(model.primal_feature_map_.affine_feature_map.scale_, 1.0)


# ----------------------------------------------- JAX state dicts of the new routes

_JAX_MODELS = {
    "dual": lambda: j_est.NeoLSSVM(),
    "device_route": lambda: j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=64), pre_transform="device"),
    "device_route_int8": lambda: j_est.NeoLSSVM(
        primal_feature_map=JaxORFF(num_features=64), pre_transform="device", transfer="int8"
    ),
}


@pytest.mark.parametrize("kind", sorted(_JAX_MODELS))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_from_jax_state_dict_restores_the_new_routes(task: str, kind: str) -> None:
    X, y, X_test = _data(task)
    n = 600 if kind == "dual" else N
    theirs = _JAX_MODELS[kind]().fit(X[:n], y[:n])
    ours = from_jax_state_dict(theirs.to_state_dict(), device="cpu")
    assert (ours.dual_, ours.pre_transform_, ours.transfer_) == (theirs.dual_, theirs.pre_transform_, theirs.transfer_)
    assert ours.γ_ == theirs.γ_
    if kind == "dual":
        assert type(ours.dual_feature_map_).__name__ == "AffineSeparator"
    if kind == "device_route_int8":
        # Each side quantises a chunk on the same grid; what differs is the product's order.
        tol = {"rtol": 1e-8, "atol": 1e-10}
    else:
        tol = {"rtol": 1e-10, "atol": 1e-12}
    if task == "classification":
        np.testing.assert_array_equal(ours.predict(X_test), theirs.predict(X_test))
    else:
        np.testing.assert_allclose(ours.predict(X_test), theirs.predict(X_test), **tol)
    np.testing.assert_allclose(ours.decision_function(X_test), theirs.decision_function(X_test), **tol)
    np.testing.assert_allclose(ours.predict_std(X_test), theirs.predict_std(X_test), **tol)
