"""Checkpoint/resume: fitted models ⇄ nested dicts of plain arrays.

The reference persists models only through sklearn-style pickling of fitted attributes
(SURVEY.md §5.4). This module adds an explicit ``to_state_dict``/``from_state_dict``
protocol producing a nested dict of NumPy arrays and scalars, directly storable with
``np.savez`` or JSON plus arrays, while pickle keeps working as before.

PyTorch port of ``neo_ls_svm_tpu.utils.serialization``, with the same nested layout and
``format_version``: a dict written by either package is read by the other's loader, since
it holds plain data only. The device is a resource of the process, not model state, so no
dict names one: the loaders take ``device=`` and default to the card.
``from_jax_state_dict`` is the loader under the name the carried-across case goes by: it
restores the solver state of either route, the feature maps, the isotonic calibrator, the
eight ``*_calib_l{1,2}_`` arrays and the fitted conformal levels. Nothing of the JAX package
is imported.
"""

import importlib
import warnings
from typing import Any

import numpy as np
import torch

from neo_ls_svm_torch.utils.base import BaseEstimator

_CONFORMAL_TARGETS = ("Δŷ", "Δŷ/ŷ")
# Host copies of the solver state that carry no trailing underscore.
_PRIVATE_STATE = ("_M_map", "_b_map", "_eig_Qs", "_eig_lam", "_inv_c0", "_chol")
# Carried as components or under "conformal"/"meta", or not model state at all (device_,
# mesh_: resources of the process).
_SKIPPED_ATTRS = frozenset(
    {
        "conformal_l1_",
        "conformal_l2_",
        "primal_feature_map_",
        "dual_feature_map_",
        "predict_proba_calibrator_",
        "y_dtype_",
        "device_",
        "mesh_",
    }
)
_COMPONENTS = ("primal_feature_map_", "dual_feature_map_", "predict_proba_calibrator_")


def _registry() -> dict[str, type]:
    from neo_ls_svm_torch.models.cqr import CoherentLinearQuantileRegressor  # noqa: PLC0415
    from neo_ls_svm_torch.models.isotonic import IsotonicCalibrator  # noqa: PLC0415
    from neo_ls_svm_torch.ops.affine import AffineFeatureMap, AffineNormalizer, AffineSeparator  # noqa: PLC0415
    from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures, RandomFourierFeatures  # noqa: PLC0415

    return {
        c.__name__: c
        for c in (
            AffineFeatureMap,
            AffineNormalizer,
            AffineSeparator,
            OrthogonalRandomFourierFeatures,
            RandomFourierFeatures,
            CoherentLinearQuantileRegressor,
            IsotonicCalibrator,
        )
    }


def _component_state(obj: BaseEstimator) -> dict[str, Any]:
    """Constructor params + fitted ``*_`` attributes of a leaf component."""
    fitted = {k: v for k, v in vars(obj).items() if k.endswith("_") and not k.startswith("_")}
    params = {
        # Nested estimator params are carried as separate component states.
        k: (None if isinstance(v, BaseEstimator) else v)
        for k, v in obj.get_params(deep=False).items()
        if k != "device"
    }
    return {
        "class": type(obj).__name__,
        # Module and qualname let a class outside the registry (e.g. a custom feature map)
        # round-trip, provided its defining module is importable at restore time.
        "module": type(obj).__module__,
        "qualname": type(obj).__qualname__,
        "params": params,
        "fitted": fitted,
    }


def _restore_component(
    state: dict[str, Any], registry: dict[str, type], device: Any, required: bool = True
) -> BaseEstimator | None:
    """Rebuild a component. The registry's class of that name comes first, so a dict
    written by the JAX package restores onto the port's classes; any other class is
    imported from the module the dict names, never from the JAX package."""
    cls = registry.get(state["class"])
    if cls is None:
        module, qualname = state.get("module"), state.get("qualname")
        try:
            if str(module).split(".")[0] == "neo_ls_svm_tpu":
                raise ImportError(module)  # the port imports nothing of the JAX package
            target: Any = importlib.import_module(module)
            for part in qualname.split("."):
                target = getattr(target, part)
            cls = target
        except (ImportError, AttributeError, TypeError) as error:
            if not required:
                return None
            msg = (
                f"Cannot restore component {state['class']!r}: not in the built-in "
                f"registry and {module}.{qualname} is not importable. Make the class's "
                f"defining module importable, or restore via pickle instead."
            )
            raise ValueError(msg) from error
    params = dict(state["params"])
    if "device" in cls._get_param_names():
        params["device"] = device
    obj = cls(**params)
    for name, value in state["fitted"].items():
        setattr(obj, name, value)
    return obj


def _storable(v: Any) -> bool:
    return v is None or isinstance(v, (str, bool, int, float, np.generic, np.ndarray, tuple))


def _conformal_key(target_type: str, key: tuple[float, ...]) -> str:
    return f"{target_type}|{','.join(map(str, key))}"


def _parse_conformal_key(joint_key: str) -> tuple[str, tuple[float, ...]]:
    target_type, _, quantile_str = joint_key.partition("|")
    return target_type, tuple(float(q) for q in quantile_str.split(","))


def model_to_state_dict(model: Any) -> dict[str, Any]:
    """Serialise a fitted ``NeoLSSVM`` into a nested dict of arrays and scalars."""
    # The calibration state a fit defers is made first.
    model._materialize_calibrator()
    model._materialize_conformal_split()
    # Resources of the process (the device, a mesh) are not part of the persisted state:
    # a mesh-fitted model is stored with mesh=None and restores on one device.
    all_params = {k: v for k, v in model.get_params(deep=False).items() if k != "device"}
    all_params["mesh"] = None
    simple_params = {
        k: (v if _storable(v) else None) for k, v in all_params.items() if not isinstance(v, BaseEstimator)
    }
    dropped = [k for k, v in all_params.items() if not isinstance(v, BaseEstimator) and not _storable(v)]
    if dropped:
        warnings.warn(
            f"Parameters {dropped} are not storable in a state dict and will restore as None.",
            UserWarning,
            stacklevel=2,
        )
    state: dict[str, Any] = {
        "format_version": 1,
        "params": simple_params,
        "component_params": {
            k: _component_state(v) for k, v in all_params.items() if isinstance(v, BaseEstimator)
        },
        "meta": {
            "estimator_type": model._estimator_type,
            "y_dtype": np.dtype(model.y_dtype_).str,
        },
        "attrs": {},
        "components": {},
        "conformal": {"l1": {}, "l2": {}},
    }
    fitted = model._fitted_state()
    for name, value in fitted.items():
        keep = (name.endswith("_") and not name.startswith("__")) or name in _PRIVATE_STATE
        if keep and name not in _SKIPPED_ATTRS:
            state["attrs"][name] = value
    for comp in _COMPONENTS:
        obj = fitted.get(comp)
        if obj is None:
            continue
        state["components"][comp] = _component_state(obj)
        if comp.endswith("feature_map_") and hasattr(obj, "affine_feature_map"):
            state["components"][comp]["affine"] = _component_state(obj.affine_feature_map)
    for target_type, fitted in model.conformal_l1_.items():
        for key, cqr in fitted.items():
            state["conformal"]["l1"][_conformal_key(target_type, key)] = _component_state(cqr)
    for target_type, biases in model.conformal_l2_.items():
        for key, bias in biases.items():
            state["conformal"]["l2"][_conformal_key(target_type, key)] = bias
    return state


def model_from_state_dict(state: dict[str, Any], device: "str | torch.device" = "cuda") -> Any:
    """Rebuild a fitted ``NeoLSSVM`` on ``device`` from a state dict of this package
    (:func:`model_to_state_dict`) or of the JAX package (its function of that name)."""
    from neo_ls_svm_torch.models.estimator import NeoLSSVM  # noqa: PLC0415

    registry = _registry()
    known = NeoLSSVM._get_param_names()
    params = {k: v for k, v in state["params"].items() if k in known and k != "device"}
    for name, comp_state in state.get("component_params", {}).items():
        params[name] = _restore_component(comp_state, registry, device)
    model = NeoLSSVM(**params, device=device)
    model.device_ = model._resolve_device()
    model._estimator_type = state["meta"]["estimator_type"]
    model.y_dtype_ = np.dtype(state["meta"]["y_dtype"])
    for name, value in state["attrs"].items():
        if name not in ("device_", "mesh_"):
            setattr(model, name, value)
    for comp, comp_state in state["components"].items():
        # Serving a primal model needs _M_map and _b_map only, so a primal feature map
        # of a class that cannot be rebuilt here is left out, not fatal.
        obj = _restore_component(comp_state, registry, model.device_, required=comp != "primal_feature_map_")
        if obj is None:
            continue
        if "affine" in comp_state:
            obj.affine_feature_map = _restore_component(comp_state["affine"], registry, model.device_)
        setattr(model, comp, obj)
    model.conformal_l1_ = {t: {} for t in _CONFORMAL_TARGETS}
    model.conformal_l2_ = {t: {} for t in _CONFORMAL_TARGETS}
    for joint_key, cqr_state in state["conformal"]["l1"].items():
        target_type, key = _parse_conformal_key(joint_key)
        model.conformal_l1_[target_type][key] = _restore_component(cqr_state, registry, model.device_)
    for joint_key, bias in state["conformal"]["l2"].items():
        target_type, key = _parse_conformal_key(joint_key)
        model.conformal_l2_[target_type][key] = bias
    return model


def from_jax_state_dict(state: dict[str, Any], device: "str | torch.device" = "cuda") -> Any:
    """Build a fitted port ``NeoLSSVM`` on ``device`` from a JAX package state dict: the
    solver state, the feature maps, the calibrator and the conformal state."""
    return model_from_state_dict(state, device=device)
