"""The conformal stack of the port against the JAX package's (x64 on, ``device="cpu"``).

- ``_conformal_quantiles`` and ``_isotonic_proba`` on tensors against the jitted JAX
  functions ``_conformal_quantiles_device`` and ``_isotonic_proba_device``: **rtol 1e-10**
  (the same float64 arithmetic, another order of summation in the products and the std).
- The whole slice: a JAX model (regressor and classifier; primal at n = 2048 with a narrow
  feature map, dual at n = 512) carried over by ``from_jax_state_dict``, then
  ``predict_proba``, ``predict_quantiles`` (3 quantiles and 1, both priorities) and
  ``predict_interval`` against the JAX model's host lane at **rtol 1e-6**; and the port's
  own fit on the host route at the same bar (the fits agree at 1e-6, the LPs are the same).
- A single quantile gives (n, 1): the JAX host lane raises there (a known fault), so the
  port is held to the JAX device lane.
- The calibrator and the conformal split are made at first use, not in ``fit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_ls_svm_torch.models.conformal as t_conf
import neo_ls_svm_torch.models.estimator as t_est
import neo_ls_svm_tpu.models.conformal as j_conf
import neo_ls_svm_tpu.models.estimator as j_est
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils.serialization import from_jax_state_dict
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures as JaxORFF

from .conftest import make_classification_dataset, make_regression_dataset

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-9
SIZES = {"primal": 2048, "dual": 512}


@pytest.mark.parametrize("is_regressor", [True, False])
def test_conformal_quantiles_match_the_jitted_jax_function(is_regressor: bool) -> None:
    """rtol 1e-10. Two rows are built to tie the two dispersions: a tie goes to "absolute"."""
    gen = np.random.RandomState(0)
    n, Q, F = 500, 5, 2 if is_regressor else 1
    yhat, std = gen.randn(n), np.abs(gen.randn(n)) + 0.1
    yhat[:2] = 1.0  # |ŷ| = 1 and equal planes: both corrections coincide there
    beta_abs = np.sort(gen.randn(F + 1, Q), axis=1)
    beta_rel = np.sort(gen.randn(F + 1, Q), axis=1)
    bias_abs, bias_rel = 0.1 * gen.randn(Q), 0.1 * gen.randn(Q)
    args = [yhat, std, beta_abs, bias_abs, beta_rel, bias_rel]
    ours = t_conf._conformal_quantiles(*(torch.from_numpy(a) for a in args), is_regressor=is_regressor)
    theirs = j_conf._conformal_quantiles_device(*(jnp.asarray(a) for a in args), is_regressor=is_regressor)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-10, atol=1e-13)
    tied = [yhat, std, beta_abs, bias_abs, beta_abs, bias_abs]
    tied_out = t_conf._conformal_quantiles(*(torch.from_numpy(a) for a in tied), is_regressor=is_regressor)
    tied_jax = j_conf._conformal_quantiles_device(*(jnp.asarray(a) for a in tied), is_regressor=is_regressor)
    np.testing.assert_allclose(tied_out.numpy()[:2], np.asarray(tied_jax)[:2], rtol=1e-10, atol=1e-13)


def test_isotonic_proba_matches_the_jitted_jax_function() -> None:
    """rtol 1e-10, out-of-range scores and duplicate thresholds included."""
    gen = np.random.RandomState(1)
    x_thr = np.sort(gen.randn(200))
    x_thr[50] = x_thr[51]  # a zero-width bracket
    y_thr = np.sort(gen.rand(200))
    scores = np.sort(3 * gen.randn(300, 4), axis=1)
    ours = t_conf._isotonic_proba(*(torch.from_numpy(a) for a in (scores, x_thr, y_thr)))
    theirs = j_conf._isotonic_proba_device(*(jnp.asarray(a) for a in (scores, x_thr, y_thr)))
    assert ours.shape == (300, 4, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("priority", ["accuracy", "coverage"])
def test_coverage_clamped_biases_equal_the_jax_package(priority: str) -> None:
    gen = np.random.RandomState(2)
    q = np.array([0.05, 0.5, 0.95])
    a, r = gen.randn(3), gen.randn(3)
    for ours, theirs in zip(t_conf._coverage_clamped_biases(a, r, q, priority), j_conf._coverage_clamped_biases(a, r, q, priority)):
        np.testing.assert_array_equal(ours, theirs)
    assert t_conf.CONFORMAL_L2_MIN == j_conf.CONFORMAL_L2_MIN


def _data(task: str, route: str):
    n = SIZES[route]
    make = make_regression_dataset if task == "regression" else make_classification_dataset
    X, y = make(n=n + 250, seed=23)
    return X[:n], y[:n], X[n:]


_MODELS: dict = {}


def _models(task: str, route: str):
    """(the JAX model, the same model carried over, the port's own fit, held-out rows),
    fitted once per process."""
    if (task, route) not in _MODELS:
        X, y, X_test = _data(task, route)
        theirs = j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=48), pre_transform="host").fit(X, y)
        # The JAX model fits its conformal levels first, so that the state dict carries
        # them: the carried-over model then serves the JAX package's own planes.
        for call in _CALLS.values():
            call(theirs, X_test[:2])
        carried = from_jax_state_dict(theirs.to_state_dict(), device="cpu")
        assert {k for t in carried.conformal_l1_.values() for k in t} == {k for t in theirs.conformal_l1_.values() for k in t}
        ours = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=48), device="cpu").fit(X, y)
        assert theirs.dual_ == carried.dual_ == ours.dual_ == (route == "dual")
        _MODELS[task, route] = theirs, carried, ours, X_test
    return _MODELS[task, route]


_CALLS = {
    "predict_proba": lambda m, X: m.predict_proba(X),
    "quantiles_3_accuracy": lambda m, X: m.predict_quantiles(X),
    "quantiles_3_coverage": lambda m, X: m.predict_quantiles(X, quantiles=(0.1, 0.5, 0.9), priority="coverage"),
    "interval": lambda m, X: m.predict_interval(X, coverage=0.8),
    "predict_coverage": lambda m, X: m.predict(X, coverage=0.9),
    "predict_quantiles_kw": lambda m, X: m.predict(X, quantiles=(0.25, 0.75)),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_slice_matches_the_jax_host_lane(task: str, route: str, call: str) -> None:
    """The carried-over model and the port's own fit against the JAX host lane: rtol 1e-6."""
    theirs, carried, ours, X_test = _models(task, route)
    want = _CALLS[call](theirs, X_test)
    for model in (carried, ours):
        got = _CALLS[call](model, X_test)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("priority", ["accuracy", "coverage"])
@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_single_quantile_gives_a_column_as_the_jax_device_lane(task: str, route: str, priority: str) -> None:
    """One quantile: (n, 1) on both of the port's lanes. The JAX host lane raises there, so
    the values are held to its device lane, at rtol 1e-6."""
    theirs, carried, ours, X_test = _models(task, route)
    want = np.asarray(theirs.predict_quantiles(jnp.asarray(X_test), quantiles=(0.3,), priority=priority))
    assert want.shape == ((len(X_test), 1) if task == "regression" else (len(X_test), 1, 2))
    for model in (carried, ours):
        got = model.predict_quantiles(X_test, quantiles=(0.3,), priority=priority)
        got_tensor = model.predict_quantiles(torch.from_numpy(X_test), quantiles=(0.3,), priority=priority)
        for out in (got, got_tensor.numpy()):
            assert out.shape == want.shape
            np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_calibration_state_waits_for_its_first_use(task: str) -> None:
    X, y, X_test = _data(task, "primal")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    lazy = ("predict_proba_calibrator_", "conformal_l1_", "ŷ_calib_l1_", "sample_weight_calib_l2_")
    after_fit = dict(vars(model))
    assert not any(name in model._fitted_state() for name in lazy)
    model.predict(X_test)
    model.predict_std(X_test)
    assert not any(name in model._fitted_state() for name in lazy)
    model.predict_proba(X_test)
    assert ("predict_proba_calibrator_" in model._fitted_state()) == (task == "classification")
    assert "conformal_l1_" not in model._fitted_state()
    assert hasattr(model, "predict_proba_calibrator_") == (task == "classification")
    assert model.ŷ_calib_l1_.shape == (min(1440, max(1024, 2 * len(y) // 3), len(y) - 1),)
    assert all(name in model._fitted_state() for name in lazy[1:])
    # What a first use makes is kept beside the fit's inputs: serving leaves the fit's
    # __dict__ as it was (sklearn's check_dict_unchanged).
    assert vars(model) == after_fit
    with pytest.raises(AttributeError, match="no_such_attribute_"):
        model.no_such_attribute_  # noqa: B018
    # A refit drops what the last fit left.
    model.fit(X[:1500], y[:1500])
    assert not any(name in model._fitted_state() for name in lazy)
    assert model.ŷ_calib_l1_.shape == (1024,)


def test_calibration_split_equals_the_jax_package() -> None:
    theirs, _, ours, _ = _models("regression", "primal")
    for level in ("l1", "l2"):
        for stem in ("nonconformity", "ŷ", "residuals", "sample_weight"):
            name = f"{stem}_calib_{level}_"
            np.testing.assert_allclose(getattr(ours, name), getattr(theirs, name), rtol=RTOL, atol=ATOL, err_msg=name)
    _, _, clf, _ = _models("classification", "primal")
    jax_clf = _models("classification", "primal")[0]
    np.testing.assert_allclose(
        clf.predict_proba_calibrator_.y_thresholds_, jax_clf.predict_proba_calibrator_.y_thresholds_, rtol=RTOL, atol=ATOL
    )


def test_smooth_conformal_method_matches_jax_and_refits_after_a_switch() -> None:
    """``conformal_method="smooth"``: the T = 2 batched Newton lane against the JAX model's,
    at rtol 1e-5 (the smooth solver's bar). Then the method is switched on the fitted
    model: the cached planes of the other method must not be served."""
    X, y, X_test = _data("regression", "primal")
    X, y = X[:1100], y[:1100]
    params = {"conformal_method": "smooth"}
    ours = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=24), device="cpu", **params).fit(X, y)
    theirs = j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=24), pre_transform="host", **params).fit(X, y)
    smooth = ours.predict_interval(X_test, coverage=0.8)
    np.testing.assert_allclose(smooth, theirs.predict_interval(X_test, coverage=0.8), rtol=1e-5, atol=1e-7)
    key = next(iter(ours.conformal_l1_["Δŷ"]))
    assert ours.conformal_l1_["Δŷ"][key].method == "smooth"
    ours.set_params(conformal_method="exact")
    exact = ours.predict_interval(X_test, coverage=0.8)
    assert ours.conformal_l1_["Δŷ"][key].method == "exact"
    fresh = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=24), device="cpu").fit(X, y)
    np.testing.assert_array_equal(exact, fresh.predict_interval(X_test, coverage=0.8))
    assert np.max(np.abs(exact - smooth)) > 0
    on_tensor = ours.predict_interval(torch.from_numpy(X_test), coverage=0.8)
    np.testing.assert_array_equal(on_tensor.numpy(), exact)


def test_predict_quantiles_defaults_and_pandas_output() -> None:
    pd = pytest.importorskip("pandas")
    theirs, _, ours, X_test = _models("regression", "primal")
    assert ours.predict_quantiles(X_test).shape == (len(X_test), 3)
    frame = pd.DataFrame(X_test, index=pd.RangeIndex(5, 5 + len(X_test), name="row"))
    got, want = ours.predict_quantiles(frame), theirs.predict_quantiles(frame)
    assert list(got.columns) == [0.025, 0.5, 0.975] and got.columns.name == "quantile"
    assert got.index.equals(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=RTOL, atol=ATOL)
    jax_clf, _, clf, X_clf = _models("classification", "primal")
    frame = pd.DataFrame(X_clf, index=pd.RangeIndex(5, 5 + len(X_clf), name="row"))
    got, want = clf.predict_quantiles(frame), jax_clf.predict_quantiles(frame)
    assert got.index.equals(want.index) and got.index.names == ["class", "row"]
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=RTOL, atol=ATOL)
    proba, want = clf.predict_proba(frame), jax_clf.predict_proba(frame)
    assert list(proba.columns) == list(want.columns) and proba.index.equals(want.index)
    np.testing.assert_allclose(proba.to_numpy(), want.to_numpy(), rtol=RTOL, atol=ATOL)
    series = ours.predict_proba(pd.DataFrame(_models("regression", "primal")[3]))
    assert isinstance(series, pd.Series)


def test_predict_rejects_coverage_and_quantiles_together() -> None:
    _, _, ours, X_test = _models("regression", "primal")
    with pytest.raises(ValueError, match="not both"):
        ours.predict(X_test, coverage=0.9, quantiles=(0.1, 0.9))
