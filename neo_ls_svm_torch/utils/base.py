"""Minimal sklearn-compatible estimator base classes.

The reference inherits from ``sklearn.base.BaseEstimator`` everywhere; this package must
not depend on scikit-learn, so we provide the same constructor-params-as-config protocol
(``get_params`` / ``set_params`` / ``clone``; ref ``_neo_ls_svm.py:43``,
``_affine_feature_map.py:17``) ourselves. ``sklearn.clone`` works on these classes when
scikit-learn happens to be installed, because it only relies on this protocol.

A copy of ``neo_ls_svm_tpu.utils.base``: the port imports nothing of the JAX package.
"""

import copy
import inspect
from typing import Any


def sklearn_tags(kind: str | None, *, target_required: bool, multi_class: bool = True):  # noqa: ANN201
    """sklearn's ``Tags`` for an estimator of ``kind`` ("classifier", "regressor",
    "transformer" or None). Imports scikit-learn, which only its callers need."""
    from sklearn.utils import (  # noqa: PLC0415
        ClassifierTags,
        InputTags,
        RegressorTags,
        Tags,
        TargetTags,
        TransformerTags,
    )

    return Tags(
        estimator_type=kind,
        target_tags=TargetTags(required=target_required),
        transformer_tags=TransformerTags() if kind == "transformer" else None,
        classifier_tags=ClassifierTags(multi_class=multi_class) if kind == "classifier" else None,
        regressor_tags=RegressorTags() if kind == "regressor" else None,
        input_tags=InputTags(),
    )


class BaseEstimator:
    """Constructor-parameters-as-configuration base class."""

    @classmethod
    def _get_param_names(cls) -> list[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        names = [
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]
        return sorted(names)

    def get_params(self, deep: bool = True) -> dict[str, Any]:
        """Return this estimator's constructor parameters."""
        params: dict[str, Any] = {}
        for name in self._get_param_names():
            value = getattr(self, name)
            params[name] = value
            if deep and hasattr(value, "get_params") and not isinstance(value, type):
                for sub_name, sub_value in value.get_params(deep=True).items():
                    params[f"{name}__{sub_name}"] = sub_value
        return params

    def set_params(self, **params: Any) -> "BaseEstimator":
        """Update this estimator's constructor parameters."""
        if not params:
            return self
        valid = set(self._get_param_names())
        nested: dict[str, dict[str, Any]] = {}
        for key, value in params.items():
            if "__" in key:
                head, _, tail = key.partition("__")
                nested.setdefault(head, {})[tail] = value
            else:
                if key not in valid:
                    msg = f"Invalid parameter {key!r} for estimator {self!r}."
                    raise ValueError(msg)
                setattr(self, key, value)
        for head, sub_params in nested.items():
            if head not in valid:
                msg = f"Invalid parameter {head!r} for estimator {self!r}."
                raise ValueError(msg)
            getattr(self, head).set_params(**sub_params)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{type(self).__name__}({params})"

    def _fitted_attribute_names(self) -> list[str]:
        return [k for k in vars(self) if k.endswith("_") and not k.startswith("_")]

    # sklearn interop: the kind subclasses advertise ("classifier", "regressor",
    # "transformer", or None). Only consulted when scikit-learn is installed.
    _estimator_kind: str | None = None

    def __sklearn_tags__(self):  # noqa: ANN204 - sklearn protocol type lives in sklearn
        kind = self._estimator_kind
        if kind is None:
            # Derive from the classic sklearn markers: RegressorMixin-style
            # `_estimator_type` strings first, then a `transform` method.
            derived = getattr(self, "_estimator_type", None)
            if isinstance(derived, str):
                kind = derived
            elif hasattr(self, "transform"):
                kind = "transformer"
        return sklearn_tags(kind, target_required=kind in ("classifier", "regressor"))

    # ------------------------------------------------------- sklearn metadata routing
    # The reference inherits `get_metadata_routing`/`set_{fit,predict,score}_request`
    # from sklearn.base.BaseEstimator (auto-generated for every explicit non-X/y
    # keyword argument). This package is sklearn-free, so the same protocol is built
    # here on sklearn's *public* `metadata_routing` API, lazily imported — routing only
    # matters inside sklearn meta-estimators, where sklearn is present by definition.

    #: Methods sklearn's MetadataRequest models and we expose requests for.
    _ROUTING_METHODS = ("fit", "predict", "predict_proba", "decision_function", "score")

    @classmethod
    def _routing_metadata_params(cls, method_name: str) -> list[str]:
        """Explicit non-X/y keyword parameters of ``method_name`` (= routable metadata)."""
        method = getattr(cls, method_name, None)
        if method is None or not callable(method):
            return []
        try:
            sig = inspect.signature(method)
        except (TypeError, ValueError):  # pragma: no cover - builtins without signatures
            return []
        skip = {"self", "X", "y"}
        return [
            p.name
            for p in sig.parameters.values()
            if p.name not in skip and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_metadata_routing(self):  # noqa: ANN201 - sklearn protocol type lives in sklearn
        """Return this estimator's sklearn ``MetadataRequest`` (routing protocol)."""
        from sklearn.utils.metadata_routing import MetadataRequest  # noqa: PLC0415

        request = MetadataRequest(owner=type(self).__name__)
        overrides: dict[str, dict[str, Any]] = getattr(self, "_metadata_request_overrides", {})
        for method_name in self._ROUTING_METHODS:
            method_request = getattr(request, method_name, None)
            if method_request is None:
                continue
            for param in self._routing_metadata_params(method_name):
                method_request.add_request(
                    param=param, alias=overrides.get(method_name, {}).get(param)
                )
        return request

    def _set_method_request(self, method_name: str, requests: dict[str, Any]) -> "BaseEstimator":
        valid = set(self._routing_metadata_params(method_name))
        for param, alias in requests.items():
            if param not in valid:
                msg = (
                    f"Unexpected arg {param!r} for set_{method_name}_request on "
                    f"{type(self).__name__}; routable metadata: {sorted(valid)}."
                )
                raise TypeError(msg)
            if not (alias is None or isinstance(alias, (bool, str))):
                msg = f"Request value for {param!r} must be True/False/None or a str alias."
                raise ValueError(msg)
        overrides = vars(self).setdefault("_metadata_request_overrides", {})
        overrides.setdefault(method_name, {}).update(requests)
        return self

    def set_fit_request(self, **requests: Any) -> "BaseEstimator":
        """Request metadata (e.g. ``sample_weight=True``) to be routed to ``fit``."""
        return self._set_method_request("fit", requests)

    def set_predict_request(self, **requests: Any) -> "BaseEstimator":
        """Request metadata to be routed to ``predict``."""
        return self._set_method_request("predict", requests)

    def set_score_request(self, **requests: Any) -> "BaseEstimator":
        """Request metadata (e.g. ``sample_weight=True``) to be routed to ``score``."""
        return self._set_method_request("score", requests)

    def __sklearn_clone__(self) -> "BaseEstimator":
        """Make ``sklearn.base.clone`` delegate to this package's :func:`clone`.

        sklearn's default clone only preserves its own ``_metadata_request``
        attribute; without this hook, routing requests stored in
        ``_metadata_request_overrides`` would be silently dropped by every sklearn
        meta-estimator clone (Pipeline/cross_validate re-route against an unset
        request and raise ``UnsetMetadataPassedError``)."""
        return clone(self)


class TransformerMixin:
    """Adds ``fit_transform`` to transformers."""

    def fit_transform(self, X: Any, y: Any = None, **fit_params: Any) -> Any:
        """Fit this transformer, then transform the same data."""
        return self.fit(X, y, **fit_params).transform(X)


class RegressorMixin:
    """Marker mixin for regressors."""

    _estimator_type = "regressor"


def clone(estimator: Any) -> Any:
    """Construct an unfitted estimator with the same constructor parameters."""
    if isinstance(estimator, (list, tuple)):
        return type(estimator)(clone(e) for e in estimator)
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        return copy.deepcopy(estimator)
    params = estimator.get_params(deep=False)
    params = {k: clone(v) if hasattr(v, "get_params") else copy.deepcopy(v) for k, v in params.items()}
    new = type(estimator)(**params)
    # Metadata-routing requests are configuration, not fitted state: sklearn's clone
    # preserves them, so ours does too.
    overrides = getattr(estimator, "_metadata_request_overrides", None)
    if overrides:
        new._metadata_request_overrides = copy.deepcopy(overrides)
    return new
