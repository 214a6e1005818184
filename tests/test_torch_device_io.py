"""``torch.Tensor`` in and out of the port's estimator (``device="cpu"`` here).

A tensor on the model's device goes through every serving entry and comes back a tensor on
that device, equal to the NumPy lane. The two lanes run the same programs, so they are held
at **rtol 1e-9**: the dual route applies its affine map on the host in the NumPy lane and as
one product on the device in the tensor lane, ``predict_proba`` interpolates by two
formulas, and the isotonic steps magnify such rounding (7e-12 was seen).
Validation of a tensor is metadata-only: no finiteness scan. A tensor on another device
raises ``ValueError`` naming both devices (a ``meta`` tensor stands in for the other device
here: it has a shape and a dtype and lies on no CPU). ``fit`` takes a tensor too.

A NumPy X on the device pre-transform's full-width route crosses as the caller holds it:
``upload_rows`` pads it on the device, bit for bit as the host's padded copy would, and the
fit equals the tensor lane's in every fitted attribute. The device, not the host, checks
such an X for NaN and inf; every route raises sklearn's error and leaves the estimator as it
found it.
"""

import numpy as np
import pytest
import torch

import neo_ls_svm_torch.models.estimator as t_est
from neo_ls_svm_torch.ops.affine import AffineSeparator
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils import device as t_device
from neo_ls_svm_torch.utils import profiling
from neo_ls_svm_torch.utils import validation as t_validation
from neo_ls_svm_torch.utils.transfer import upload_rows

from ._torch_compare import same
from .conftest import make_classification_dataset, make_regression_dataset

torch.set_num_threads(2)

SIZES = {"primal": 1500, "dual": 400}
ENTRIES = {
    "decision_function": lambda m, X: m.decision_function(X),
    "predict_std": lambda m, X: m.predict_std(X),
    "predict": lambda m, X: m.predict(X),
    "predict_proba": lambda m, X: m.predict_proba(X),
    "predict_quantiles": lambda m, X: m.predict_quantiles(X, quantiles=(0.1, 0.5, 0.9)),
    "predict_interval": lambda m, X: m.predict_interval(X, coverage=0.8),
    "predict_coverage": lambda m, X: m.predict(X, coverage=0.8),
}


def _data(task: str, route: str):
    n = SIZES[route]
    make = make_regression_dataset if task == "regression" else make_classification_dataset
    X, y = make(n=n + 200, seed=77)
    return X[:n], y[:n], X[n:]


_FITTED: dict = {}


def _fitted(task: str, route: str):
    if (task, route) not in _FITTED:
        X, y, X_test = _data(task, route)
        model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu").fit(X, y)
        _FITTED[task, route] = model, X_test
    return _FITTED[task, route]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_tensor_lane_equals_the_numpy_lane(task: str, route: str, entry: str) -> None:
    model, X_test = _fitted(task, route)
    on_numpy = ENTRIES[entry](model, X_test)
    on_tensor = ENTRIES[entry](model, torch.from_numpy(X_test))
    if entry == "predict" and task == "classification":
        # Class labels are mapped on the host from the pulled ŷ: NumPy out.
        assert isinstance(on_tensor, np.ndarray)
        np.testing.assert_array_equal(on_tensor, on_numpy)
        return
    assert isinstance(on_tensor, torch.Tensor) and on_tensor.device == torch.device("cpu")
    assert on_tensor.shape == on_numpy.shape
    np.testing.assert_allclose(on_tensor.numpy(), on_numpy, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_tensor_on_another_device_raises(entry: str) -> None:
    model, X_test = _fitted("regression", "primal")
    elsewhere = torch.empty(X_test.shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="on meta, but the model runs on cpu"):
        ENTRIES[entry](model, elsewhere)


def test_fit_on_a_tensor_on_another_device_raises() -> None:
    X, y, _ = _data("regression", "primal")
    elsewhere = torch.empty(X.shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="on meta, but the model runs on cpu"):
        t_est.NeoLSSVM(device="cpu").fit(elsewhere, y)


def test_same_device_treats_an_unindexed_cuda_device_as_the_current_one(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert t_device.same_device(torch.device("cuda"), torch.device("cuda", 0))
    assert not t_device.same_device(torch.device("cuda", 1), torch.device("cuda"))
    assert not t_device.same_device(torch.device("cpu"), torch.device("cuda", 0))
    assert t_device.same_device(torch.device("cpu"), torch.device("cpu"))


_BAD_SERVING = {
    "one_dimension": (lambda X: torch.from_numpy(X[:, 0]), "Expected 2D array"),
    "another_width": (lambda X: torch.from_numpy(X[:, :5]), "features"),
}


@pytest.mark.parametrize("case", sorted(_BAD_SERVING))
def test_serving_validates_a_tensor_from_its_metadata(case: str) -> None:
    make, match = _BAD_SERVING[case]
    model, X_test = _fitted("regression", "primal")
    with pytest.raises(ValueError, match=match):
        model.decision_function(make(X_test))


def test_serving_a_tensor_scans_nothing_and_casts_to_the_models_dtype() -> None:
    model, X_test = _fitted("regression", "primal")
    poisoned = X_test.copy()
    poisoned[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        model.decision_function(poisoned)  # the NumPy lane keeps the sklearn contract
    out = model.decision_function(torch.from_numpy(poisoned))  # the tensor lane does not scan
    assert torch.isnan(out[3]) and torch.isfinite(out[:3]).all()
    narrow = model.predict(torch.from_numpy(X_test.astype(np.float32)))
    assert narrow.dtype == torch.float64  # the model's compute dtype, then y's dtype
    np.testing.assert_allclose(narrow.numpy(), model.predict(X_test), rtol=1e-5, atol=1e-6)


def test_score_takes_tensors() -> None:
    model, X_test = _fitted("regression", "primal")
    y = model.predict(X_test)
    assert model.score(torch.from_numpy(X_test), torch.from_numpy(y)) == pytest.approx(1.0)


# --------------------------------------------------------------------------- fit


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_fit_on_a_tensor_takes_the_device_pre_transform_and_equals_the_numpy_fit(task: str) -> None:
    X, y, X_test = _data(task, "primal")
    params = {"primal_feature_map": TorchORFF(num_features=32), "device": "cpu"}
    y_in = torch.from_numpy(y) if task == "regression" else y  # string labels stay on the host
    w = np.random.RandomState(3).rand(len(y)) + 0.5
    from_tensor = t_est.NeoLSSVM(**params).fit(torch.from_numpy(X), y_in, torch.from_numpy(w))
    from_numpy = t_est.NeoLSSVM(pre_transform="device", **params).fit(X, y, w)
    assert (from_tensor.pre_transform_, from_tensor.transfer_) == ("device", "float32")
    assert from_tensor.γ_ == from_numpy.γ_ and from_tensor.loo_score_ == from_numpy.loo_score_
    np.testing.assert_array_equal(from_tensor.loo_residuals_, from_numpy.loo_residuals_)
    np.testing.assert_array_equal(from_tensor.decision_function(X_test), from_numpy.decision_function(X_test))
    np.testing.assert_array_equal(from_tensor.predict_interval(X_test), from_numpy.predict_interval(X_test))


def test_streaming_fit_on_a_tensor_pads_on_the_device(monkeypatch) -> None:
    monkeypatch.setattr(t_est, "STREAMING_BYTES_THRESHOLD", 0)
    monkeypatch.setattr(t_est, "STREAMING_ROW_CHUNK", 512)  # 1500 rows → 36 padding rows
    X, y, X_test = _data("regression", "primal")
    params = {"primal_feature_map": TorchORFF(num_features=32), "device": "cpu", "pre_transform": "device"}
    from_tensor = t_est.NeoLSSVM(**params).fit(torch.from_numpy(X), y)
    from_numpy = t_est.NeoLSSVM(**params).fit(X, y)
    assert from_tensor.loo_residuals_.shape == (len(y),)
    assert from_tensor.γ_ == from_numpy.γ_
    np.testing.assert_array_equal(from_tensor.predict(X_test), from_numpy.predict(X_test))


_HOST_ROUTES = {
    "dual_route": ({}, 400),
    "host_pre_transform_asked": ({"pre_transform": "host", "primal_feature_map": TorchORFF(num_features=32)}, 1500),
    "custom_complexity_matrix": ({"primal_feature_map": None}, 1500),
    "custom_dual_feature_map": ({"dual_feature_map": AffineSeparator(), "dual": True}, 1200),
}


class _CustomComplexityORFF(TorchORFF):
    @property
    def complexity_matrix(self):
        return np.diag(np.linspace(1.0, 2.0, self.num_features + 1)).astype(self.Z_.dtype)


@pytest.mark.parametrize("case", sorted(_HOST_ROUTES))
def test_fit_on_a_tensor_pulls_once_where_the_route_needs_the_host(case: str) -> None:
    """The dual route, ``pre_transform="host"`` and a feature map the device pre-transform
    does not cover take the host pre-transform: the tensor is pulled, and the fit is the
    NumPy fit bit for bit."""
    params, n = _HOST_ROUTES[case]
    params = dict(params)
    if case == "custom_complexity_matrix":
        params["primal_feature_map"] = _CustomComplexityORFF(num_features=24)
    X, y, X_test = _data("regression", "primal")
    X, y = X[:n], y[:n]
    from_tensor = t_est.NeoLSSVM(device="cpu", **params).fit(torch.from_numpy(X), torch.from_numpy(y))
    from_numpy = t_est.NeoLSSVM(device="cpu", **params).fit(X, y)
    assert from_tensor.pre_transform_ == from_numpy.pre_transform_ == "host"
    assert from_tensor.dual_ == from_numpy.dual_
    assert from_tensor.γ_ == from_numpy.γ_
    np.testing.assert_array_equal(from_tensor.predict(X_test), from_numpy.predict(X_test))
    on_tensor = from_tensor.predict_std(torch.from_numpy(X_test))
    np.testing.assert_allclose(on_tensor.numpy(), from_numpy.predict_std(X_test), rtol=1e-9, atol=1e-12)


_BAD_FITS = {
    "one_dimension": (lambda X, y: (torch.from_numpy(X[:, 0]), y), {}, "Expected 2D array"),
    "one_sample": (lambda X, y: (torch.from_numpy(X[:1]), y[:1]), {}, "minimum of 2"),
    "no_feature": (lambda X, y: (torch.from_numpy(X[:, :0]), y), {}, "0 feature"),
    "complex": (lambda X, y: (torch.from_numpy(X).to(torch.complex64), y), {}, "Complex data"),
    "lengths_differ": (lambda X, y: (torch.from_numpy(X), y[:-3]), {}, "inconsistent numbers of samples"),
    "nan_in_y": (lambda X, y: (torch.from_numpy(X), np.where(np.arange(len(y)) == 5, np.nan, y)), {}, "Input y contains NaN"),
    "transfer_bfloat16": (lambda X, y: (torch.from_numpy(X), y), {"transfer": "bfloat16"}, "no upload to narrow"),
    "transfer_int8": (lambda X, y: (torch.from_numpy(X), y), {"transfer": "int8", "pre_transform": "device"}, "no upload to narrow"),
}


@pytest.mark.parametrize("case", sorted(_BAD_FITS))
def test_fit_validates_a_tensor_from_its_metadata(case: str) -> None:
    make, params, match = _BAD_FITS[case]
    X, y, _ = _data("regression", "primal")
    X_in, y_in = make(X, y)
    with pytest.raises(ValueError, match=match):
        t_est.NeoLSSVM(device="cpu", **params).fit(X_in, y_in)


def test_fit_on_a_tensor_scans_no_feature_and_widens_other_dtypes() -> None:
    X, y, X_test = _data("regression", "primal")
    ints = np.round(4 * X).astype(np.int32)
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(torch.from_numpy(ints), y)
    assert model._compute_dtype() == np.float64  # as check_X_y widens
    assert np.isfinite(model.loo_score_)
    narrow = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(
        torch.from_numpy(X.astype(np.float32)), y
    )
    assert narrow._compute_dtype() == np.float32
    assert narrow.predict(torch.from_numpy(X_test.astype(np.float32))).dtype == torch.float64  # y's dtype


# ------------------------------------------------- a NumPy X staged on the device

# A NumPy fit's routes: the parameters, the rows, and whether the device (True) or the host
# checks X for NaN and inf.
_NUMPY_ROUTES = {
    "streaming_device": ({"pre_transform": "device"}, 1500, True),
    "inmemory_device": ({"pre_transform": "device"}, 1500, True),
    "host_pre_transform": ({"pre_transform": "host"}, 1500, False),
    "dual": ({}, 400, False),
    "bfloat16": ({"pre_transform": "device", "transfer": "bfloat16"}, 1500, False),
    "int8": ({"pre_transform": "device", "transfer": "int8"}, 1500, False),
}


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("route", sorted(_NUMPY_ROUTES))
def test_nan_or_inf_in_numpy_x_raises_on_every_route_and_leaves_no_fitted_state(route, poison, monkeypatch) -> None:
    params, n, on_device = _NUMPY_ROUTES[route]
    if route == "streaming_device":
        monkeypatch.setattr(t_est, "STREAMING_BYTES_THRESHOLD", 0)
        monkeypatch.setattr(t_est, "STREAMING_ROW_CHUNK", 512)
    X, y, _ = _data("regression", "primal")
    X, y = X[:n].copy(), y[:n]
    X[n - 7, 3] = poison  # one value, near the end of the rows
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu", **params)
    unfitted = set(vars(model))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match=r"^Input contains NaN or infinity\.$"):
            model.fit(X, y)
    assert set(vars(model)) == unfitted
    with pytest.raises(t_validation.NotFittedError):
        model.predict(X[:5])
    # A region that raises leaves no record: the device's check ran after a finished validation.
    finished = [r["name"] for r in profiling.spans()]
    assert ("neo.fit.validate" in finished) == on_device and "neo.fit.finite" not in finished


def test_a_refit_that_finds_nan_on_the_device_keeps_the_previous_fit() -> None:
    X, y, X_test = _data("regression", "primal")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu", pre_transform="device")
    before = model.fit(X, y).predict(X_test)
    fitted = dict(vars(model))
    poisoned = X.copy()
    poisoned[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        model.fit(poisoned, y[::-1])
    assert vars(model).keys() == fitted.keys() and all(vars(model)[k] is v for k, v in fitted.items())
    np.testing.assert_array_equal(model.predict(X_test), before)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_upload_rows_pads_on_the_device_as_the_host_padded_upload(dtype, transfer) -> None:
    rows, pad = 1000, (-1000) % 384
    X = (np.random.RandomState(5).randn(rows, 6) * [1, 10, 1e-3, 0, 1e4, 1]).astype(dtype)
    padded = np.vstack([X, np.zeros((pad, X.shape[1]), dtype)])
    cpu = torch.device("cpu")
    grid = X if transfer == "int8" else None  # the fit's grid: the real rows alone
    on_device = upload_rows(X, transfer, cpu, grid_rows=grid, pad_rows=pad)
    on_host = upload_rows(padded, transfer, cpu, grid_rows=grid)
    assert on_device.dtype == on_host.dtype == torch.from_numpy(X).dtype
    assert on_device.shape == (rows + pad, X.shape[1])
    assert on_device.numpy().tobytes() == on_host.numpy().tobytes()
    assert not on_device[rows:].numpy().any() and not np.signbit(on_device[rows:].numpy()).any()


def test_streaming_numpy_fit_equals_the_tensor_lane_in_every_fitted_attribute(monkeypatch) -> None:
    monkeypatch.setattr(t_est, "STREAMING_BYTES_THRESHOLD", 0)
    monkeypatch.setattr(t_est, "STREAMING_ROW_CHUNK", 512)  # 1500 rows → 36 padding rows
    X, y, _ = _data("classification", "primal")
    params = {"primal_feature_map": TorchORFF(num_features=32), "device": "cpu", "pre_transform": "device"}
    from_numpy = t_est.NeoLSSVM(**params).fit(X, y)
    from_tensor = t_est.NeoLSSVM(**params).fit(torch.from_numpy(X), y)
    assert from_numpy.pre_transform_ == "device"
    numpy_state, tensor_state = from_numpy._fitted_state(), from_tensor._fitted_state()
    assert numpy_state.keys() == tensor_state.keys()
    for name, value in numpy_state.items():
        assert same(value, tensor_state[name]), name


def test_an_upload_with_no_padding_shares_the_callers_rows_on_the_cpu() -> None:
    X = np.random.RandomState(6).randn(100, 4)
    cpu = torch.device("cpu")
    assert np.shares_memory(upload_rows(X, "float32", cpu).numpy(), X)
    assert np.shares_memory(t_device.to_device(X, cpu).numpy(), X)


@pytest.mark.parametrize("pad", [0, 7])
@pytest.mark.parametrize("source", ["same", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_padded_rows_equal_the_rows_concatenated_with_zeros(dtype, source, pad) -> None:
    a = torch.randn(50, 3, dtype=dtype)
    a = a if source == "same" else a.to(torch.bfloat16)
    out = t_device.padded(a, pad, torch.device("cpu"), dtype)
    assert out.dtype == dtype and out.shape == (50 + pad, 3)
    assert torch.equal(out, torch.cat([a.to(dtype), torch.zeros(pad, 3, dtype=dtype)]))
