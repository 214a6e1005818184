"""State dicts and pickles of the port, and state dicts carried between the packages.

``from_state_dict(to_state_dict(m))`` and a pickle round trip predict **bit for bit** what
``m`` does (the restored model serves the same arrays through the same programs). The
port's dict has the JAX package's nested layout and ``format_version``, so each package's
loader reads the other's dict: a JAX dict restored by ``from_jax_state_dict`` carries the
isotonic calibrator, the eight ``*_calib_l{1,2}_`` arrays and the fitted conformal levels
(bit-equal arrays, predictions at rtol 1e-10), and a port dict restored by the JAX loader
predicts what the port's model does at rtol 1e-10. A pickle stores no device: the loading
process serves on the device the ``device`` parameter names there, and never falls back
to the CPU.
"""

import pickle

import numpy as np
import pytest
import torch

import neo_ls_svm_torch.models.estimator as t_est
import neo_ls_svm_tpu.models.estimator as j_est
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures as TorchORFF
from neo_ls_svm_torch.utils.serialization import from_jax_state_dict, model_from_state_dict, model_to_state_dict
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures as JaxORFF
from neo_ls_svm_tpu.utils.serialization import model_from_state_dict as jax_model_from_state_dict

from .conftest import make_classification_dataset, make_regression_dataset

torch.set_num_threads(2)

CALIB = [f"{stem}_calib_{level}_" for stem in ("nonconformity", "ŷ", "residuals", "sample_weight") for level in ("l1", "l2")]
SIZES = {"primal": 1500, "dual": 400}


def _data(task: str, route: str):
    n = SIZES[route]
    make = make_regression_dataset if task == "regression" else make_classification_dataset
    X, y = make(n=n + 200, seed=61)
    return X[:n], y[:n], X[n:]


def _serve(model, X_test, task: str) -> dict:
    out = {
        "decision_function": model.decision_function(X_test),
        "predict_std": model.predict_std(X_test),
        "predict": model.predict(X_test),
        "predict_interval": model.predict_interval(X_test, coverage=0.8),
    }
    if task == "classification":
        out["predict_proba"] = model.predict_proba(X_test)
    return out


_FITTED: dict = {}


def _fitted(task: str, route: str):
    """(a port model with fitted conformal levels, what it serves, held-out rows)."""
    if (task, route) not in _FITTED:
        X, y, X_test = _data(task, route)
        model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=32), device="cpu").fit(X, y)
        _FITTED[task, route] = model, _serve(model, X_test, task), X_test
    return _FITTED[task, route]


def test_round_trip_at_the_default_width_predicts_std_bit_for_bit() -> None:
    """With the default 512 features too: the fitted model serves from the same row-major
    eigenbasis a restored one uploads, so σ comes out of the same products."""
    X, y, X_test = _data("regression", "primal")
    model = t_est.NeoLSSVM(device="cpu").fit(X, y)
    want = model.predict_std(X_test)
    for restored in (
        t_est.NeoLSSVM.from_state_dict(model.to_state_dict(), device="cpu"),
        pickle.loads(pickle.dumps(model)),
    ):
        np.testing.assert_array_equal(restored.predict_std(X_test), want)


@pytest.mark.parametrize("how", ["state_dict", "pickle"])
@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_round_trip_predicts_bit_for_bit(task: str, route: str, how: str) -> None:
    model, want, X_test = _fitted(task, route)
    if how == "state_dict":
        restored = t_est.NeoLSSVM.from_state_dict(model.to_state_dict(), device="cpu")
    else:
        restored = pickle.loads(pickle.dumps(model))
    assert "_device_cache" not in vars(restored) and "_calibration_ctx" not in vars(restored)
    assert restored.device_ == torch.device("cpu")
    got = _serve(restored, X_test, task)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)  # bit-equal
    # The fitted conformal levels travelled: nothing was fitted anew.
    assert restored.conformal_l1_["Δŷ"].keys() == model.conformal_l1_["Δŷ"].keys() != set()
    for name in CALIB:
        np.testing.assert_array_equal(getattr(restored, name), getattr(model, name))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_state_dict_of_a_fresh_fit_makes_the_deferred_calibration_state(task: str) -> None:
    X, y, X_test = _data(task, "primal")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    assert "conformal_l1_" not in model._fitted_state()
    state = model.to_state_dict()
    assert all(name in state["attrs"] for name in CALIB)
    assert ("predict_proba_calibrator_" in state["components"]) == (task == "classification")
    restored = t_est.NeoLSSVM.from_state_dict(state, device="cpu")
    np.testing.assert_array_equal(restored.predict_quantiles(X_test), model.predict_quantiles(X_test))
    blob = pickle.dumps(t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y))
    assert all(name in vars(pickle.loads(blob)) for name in CALIB)


def test_state_dict_has_the_jax_layout_and_names_no_device() -> None:
    model, _, _ = _fitted("classification", "primal")
    X, y, X_test = _data("classification", "primal")
    theirs = j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=32), pre_transform="host").fit(X, y)
    theirs.predict_interval(X_test, coverage=0.8)
    ours_state, theirs_state = model.to_state_dict(), theirs.to_state_dict()
    assert ours_state.keys() == theirs_state.keys()
    assert ours_state["format_version"] == theirs_state["format_version"] == 1
    assert ours_state["params"].keys() == theirs_state["params"].keys()  # no "device"
    assert ours_state["meta"].keys() == theirs_state["meta"].keys()
    assert ours_state["attrs"].keys() == theirs_state["attrs"].keys()
    assert ours_state["components"].keys() == theirs_state["components"].keys()
    assert ours_state["conformal"]["l1"].keys() == theirs_state["conformal"]["l1"].keys()
    assert ours_state["conformal"]["l2"].keys() == theirs_state["conformal"]["l2"].keys()
    cqr_state = next(iter(ours_state["conformal"]["l1"].values()))
    assert cqr_state["params"].keys() == next(iter(theirs_state["conformal"]["l1"].values()))["params"].keys()

    def leaves(node):
        if isinstance(node, dict):
            for value in node.values():
                yield from leaves(value)
        else:
            yield node

    assert not any(isinstance(leaf, (torch.Tensor, torch.device)) for leaf in leaves(ours_state))


@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_from_jax_state_dict_carries_the_calibrator_and_the_conformal_state(task: str, route: str) -> None:
    """Arrays bit-equal; every serving entry at rtol 1e-10 (the same planes and thresholds
    through another library's products)."""
    X, y, X_test = _data(task, route)
    theirs = j_est.NeoLSSVM(primal_feature_map=JaxORFF(num_features=32), pre_transform="host").fit(X, y)
    want = _serve(theirs, X_test, task)
    want["predict_quantiles"] = theirs.predict_quantiles(X_test)
    ours = from_jax_state_dict(theirs.to_state_dict(), device="cpu")
    for name in CALIB:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for target in ("Δŷ", "Δŷ/ŷ"):
        assert ours.conformal_l1_[target].keys() == theirs.conformal_l1_[target].keys() != set()
        for key, cqr in theirs.conformal_l1_[target].items():
            restored = ours.conformal_l1_[target][key]
            assert type(restored).__module__ == "neo_ls_svm_torch.models.cqr"
            np.testing.assert_array_equal(restored.β_, cqr.β_)
            np.testing.assert_array_equal(restored.β_full_, cqr.β_full_)
            np.testing.assert_array_equal(ours.conformal_l2_[target][key], theirs.conformal_l2_[target][key])
    if task == "classification":
        calibrator = ours.predict_proba_calibrator_
        assert type(calibrator).__module__ == "neo_ls_svm_torch.models.isotonic"
        np.testing.assert_array_equal(calibrator.X_thresholds_, theirs.predict_proba_calibrator_.X_thresholds_)
        np.testing.assert_array_equal(calibrator.y_thresholds_, theirs.predict_proba_calibrator_.y_thresholds_)
    got = _serve(ours, X_test, task)
    got["predict_quantiles"] = ours.predict_quantiles(X_test)
    for name, value in want.items():
        if name == "predict" and task == "classification":
            np.testing.assert_array_equal(got[name], value)
        else:
            np.testing.assert_allclose(got[name], value, rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("route", sorted(SIZES))
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_the_jax_loader_reads_a_port_state_dict(task: str, route: str) -> None:
    model, want, X_test = _fitted(task, route)
    theirs = jax_model_from_state_dict(model.to_state_dict())
    assert type(theirs).__module__ == "neo_ls_svm_tpu.models.estimator"
    got = _serve(theirs, X_test, task)
    for name, value in want.items():
        if name == "predict" and task == "classification":
            np.testing.assert_array_equal(got[name], value)
        else:
            np.testing.assert_allclose(got[name], value, rtol=1e-10, atol=1e-12, err_msg=name)


def test_restored_model_defaults_to_the_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device='cuda' is valid here")
    model, _, _ = _fitted("regression", "primal")
    state = model_to_state_dict(model)
    for load in (model_from_state_dict, from_jax_state_dict, t_est.NeoLSSVM.from_state_dict):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(state)


def test_pickle_restores_on_the_loading_processs_device() -> None:
    """A pickle carries no device: a model fitted on a device the loading process lacks
    (``meta`` stands for it here) serves on the device its ``device`` parameter names."""
    X, y, X_test = _data("regression", "primal")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    want = model.predict(X_test), model.predict_std(X_test)
    model.device_ = torch.device("meta")
    restored = pickle.loads(pickle.dumps(model))
    assert "device_" not in vars(restored)
    np.testing.assert_array_equal(restored.predict(X_test), want[0])
    np.testing.assert_array_equal(restored.predict_std(X_test), want[1])
    assert restored.device_ == torch.device("cpu")


def test_a_cuda_pickle_never_falls_back_to_the_cpu() -> None:
    """Unpickled where no card is, a model whose device is "cuda" stays readable, raises
    at its first prediction, and moves to the CPU only by ``from_state_dict``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    X, y, X_test = _data("regression", "primal")
    model = t_est.NeoLSSVM(primal_feature_map=TorchORFF(num_features=16), device="cpu").fit(X, y)
    model.device = "cuda"
    restored = pickle.loads(pickle.dumps(model))
    assert restored.γ_ == model.γ_
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restored.predict(X_test)
    moved = t_est.NeoLSSVM.from_state_dict(restored.to_state_dict(), device="cpu")
    np.testing.assert_array_equal(moved.predict(X_test), model.predict(X_test))


def test_custom_feature_map_round_trips_by_module_and_qualname() -> None:
    X, y, X_test = _data("regression", "primal")
    model = t_est.NeoLSSVM(primal_feature_map=NarrowORFF(), device="cpu").fit(X, y)
    state = model.to_state_dict()
    assert state["component_params"]["primal_feature_map"]["class"] == "NarrowORFF"
    restored = t_est.NeoLSSVM.from_state_dict(state, device="cpu")
    assert isinstance(restored.primal_feature_map_, NarrowORFF)
    np.testing.assert_array_equal(restored.predict(X_test), model.predict(X_test))
    state["component_params"]["primal_feature_map"]["module"] = "no_such_module"
    with pytest.raises(ValueError, match="not importable"):
        t_est.NeoLSSVM.from_state_dict(state, device="cpu")
    state["component_params"]["primal_feature_map"]["module"] = "neo_ls_svm_tpu.ops.orff"
    with pytest.raises(ValueError, match="not importable"):  # nothing of the JAX package is imported
        t_est.NeoLSSVM.from_state_dict(state, device="cpu")


class NarrowORFF(TorchORFF):
    """A feature map outside the registry, restored by module and qualname."""

    def __init__(self, *, num_features: int = 24, **kwargs) -> None:
        super().__init__(num_features=num_features, **kwargs)
