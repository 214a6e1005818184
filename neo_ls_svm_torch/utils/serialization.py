"""Carry a model fitted by the JAX package across to the port.

``from_jax_state_dict`` reads the nested dict of NumPy arrays and scalars that
``neo_ls_svm_tpu.utils.serialization.model_to_state_dict`` produces (params, fitted
``attrs`` such as ``_M_map``, ``_b_map``, ``beta_emb_``, ``_eig_Qs``, ``_eig_lam``,
``γ_``, ``_inv_c0``, ``classes_`` for a primal model, ``α̂_``, ``_chol``, ``X_`` for a dual
one, ``pre_transform_`` and ``transfer_``, components and ``meta``) and returns a fitted
port ``NeoLSSVM`` that predicts what the JAX model predicts, whichever route and
pre-transform fitted it. It reads the dict's plain data only; nothing of the JAX package is
imported.
"""

from typing import Any

import numpy as np
import torch

from neo_ls_svm_torch.models.estimator import NeoLSSVM
from neo_ls_svm_torch.ops.affine import AffineFeatureMap, AffineNormalizer, AffineSeparator
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures, RandomFourierFeatures
from neo_ls_svm_torch.utils.base import BaseEstimator

_REGISTRY = {
    c.__name__: c
    for c in (
        AffineFeatureMap,
        AffineNormalizer,
        AffineSeparator,
        OrthogonalRandomFourierFeatures,
        RandomFourierFeatures,
    )
}


def _restore_component(state: dict[str, Any]) -> BaseEstimator:
    cls = _REGISTRY.get(state["class"])
    if cls is None:
        msg = f"Cannot restore component {state['class']!r}: the port has no such class."
        raise ValueError(msg)
    obj = cls(**state["params"])
    for name, value in state["fitted"].items():
        setattr(obj, name, value)
    return obj


def from_jax_state_dict(state: dict[str, Any], device: str | torch.device = "cuda") -> NeoLSSVM:
    """Build a fitted port ``NeoLSSVM`` on ``device`` from a JAX package state dict."""
    attrs = state["attrs"]
    params = {k: v for k, v in state["params"].items() if k in NeoLSSVM._get_param_names()}
    for name, comp_state in state.get("component_params", {}).items():
        params[name] = _restore_component(comp_state)
    model = NeoLSSVM(**params, device=device)
    model.device_ = model._resolve_device()
    model._estimator_type = state["meta"]["estimator_type"]
    model.y_dtype_ = np.dtype(state["meta"]["y_dtype"])
    for name, value in attrs.items():
        setattr(model, name, value)
    for name in ("primal_feature_map_", "dual_feature_map_"):
        fmap_state = state["components"].get(name)
        if fmap_state is None:
            continue
        if name == "primal_feature_map_" and fmap_state["class"] not in _REGISTRY:
            continue  # serving a primal model needs _M_map and _b_map only
        fmap = _restore_component(fmap_state)
        if "affine" in fmap_state:
            fmap.affine_feature_map = _restore_component(fmap_state["affine"])
        setattr(model, name, fmap)
    return model
