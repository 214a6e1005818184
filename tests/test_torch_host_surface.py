"""The rest of the JAX package's surface on the port, each against its JAX counterpart.

NumPy copies bit for bit: the affine map's ``pseudo_inverse``, ``inverse_transform`` and
``get_feature_names_out``, the quantizer's ``get_feature_names_out`` and
``sample_weights_quantized_ecdf``, and ``roc_auc_score`` (also against scikit-learn, at
1e-12). The affine inverse round trip at rtol 1e-8, as ``tests/test_affine.py`` holds it.
``complexity_sinc_matrix`` (plain torch here, jitted XLA there) in float64 at rtol 1e-10,
and an estimator whose feature map takes ``complexity_matrix_exact`` as its complexity
matrix against the JAX one at rtol 1e-6. The package re-exports, and
``utils/profiling.py``'s ``trace`` writing a trace file.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics
import torch

import neo_ls_svm_torch.models as t_models
import neo_ls_svm_torch.ops as t_ops
import neo_ls_svm_tpu.models as j_models
import neo_ls_svm_tpu.ops as j_ops
import neo_ls_svm_tpu.ops.orff as j_orff
from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.ops import affine as t_affine
from neo_ls_svm_torch.ops import orff as t_orff
from neo_ls_svm_torch.ops import quantizer as t_quantizer
from neo_ls_svm_torch.utils import metrics as t_metrics
from neo_ls_svm_torch.utils.profiling import annotate, trace
from neo_ls_svm_tpu import NeoLSSVM as JaxNeoLSSVM
from neo_ls_svm_tpu.ops import affine as j_affine
from neo_ls_svm_tpu.ops import quantizer as j_quantizer
from neo_ls_svm_tpu.utils import metrics as j_metrics

from .conftest import make_regression_dataset

# The suite runs several worker processes on a few cores: more intra-op threads than that
# only contend (these shapes are small).
torch.set_num_threads(2)


def _affine_params(rng: np.random.RandomState, shape: tuple[int, int] | None) -> dict:
    params = {"scale": rng.rand(4) + 0.5, "shift": rng.randn(4)}
    if shape is not None:
        params["A"] = rng.randn(*shape)
    return params


AFFINE_CASES = {
    "square": ((4, 4), False),
    "wide": ((4, 9), False),
    "tall": ((4, 3), False),
    "appended": ((4, 4), True),
    "no_A": (None, False),
}


@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_affine_inverse_and_names_match_jax(case: str) -> None:
    shape, append = AFFINE_CASES[case]
    rng = np.random.RandomState(5)
    X = rng.randn(60, 4)
    params = {**_affine_params(rng, shape), "append_features": append}
    ours, theirs = t_affine.AffineFeatureMap(**params).fit(X), j_affine.AffineFeatureMap(**params).fit(X)
    if shape is None:
        assert ours.pseudo_inverse is None and theirs.pseudo_inverse is None
    else:
        np.testing.assert_array_equal(ours.pseudo_inverse, theirs.pseudo_inverse)
        assert ours.pseudo_inverse is ours.pseudo_inverse  # cached
    forward = ours.transform(X)
    np.testing.assert_array_equal(ours.inverse_transform(forward), theirs.inverse_transform(forward))
    np.testing.assert_array_equal(ours.get_feature_names_out(), theirs.get_feature_names_out())
    names = ["a", "b", "c", "d"]
    np.testing.assert_array_equal(ours.get_feature_names_out(names), theirs.get_feature_names_out(names))


def test_affine_inverse_round_trip() -> None:
    rng = np.random.RandomState(6)
    X = rng.randn(60, 4)
    fmap = t_affine.AffineFeatureMap(**_affine_params(rng, (4, 4))).fit(X)
    np.testing.assert_allclose(fmap.inverse_transform(fmap.transform(X)), X, rtol=1e-8)


def test_fitted_separator_names_and_inverse_match_jax() -> None:
    X, y = make_regression_dataset(n=800, seed=7)
    ours, theirs = t_affine.AffineSeparator().fit(X, y), j_affine.AffineSeparator().fit(X, y)
    np.testing.assert_array_equal(ours.get_feature_names_out(), theirs.get_feature_names_out())
    np.testing.assert_array_equal(
        ours.inverse_transform(ours.transform(X)), theirs.inverse_transform(theirs.transform(X))
    )


@pytest.mark.parametrize("append_invfreq", [False, True])
def test_quantizer_names_match_jax(append_invfreq: bool) -> None:
    X = np.random.RandomState(8).randn(500, 3)
    ours = t_quantizer.Quantizer(append_invfreq=append_invfreq).fit(X)
    theirs = j_quantizer.Quantizer(append_invfreq=append_invfreq).fit(X)
    np.testing.assert_array_equal(ours.get_feature_names_out(), theirs.get_feature_names_out())
    names = ["p", "q", "r"]
    np.testing.assert_array_equal(ours.get_feature_names_out(names), theirs.get_feature_names_out(names))


@pytest.mark.parametrize("kind", ["gaussian", "few_values", "integers"])
def test_sample_weights_quantized_ecdf_matches_jax(kind: str) -> None:
    gen = np.random.RandomState(9)
    x = {
        "gaussian": gen.randn(2048),
        "few_values": gen.randint(0, 7, 2048).astype(np.float64),
        "integers": gen.randint(0, 5000, 2048),
    }[kind]
    ours, theirs = t_quantizer.sample_weights_quantized_ecdf(x), j_quantizer.sample_weights_quantized_ecdf(x)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_roc_auc_score_matches_jax_and_sklearn(seed: int, weighted: bool) -> None:
    gen = np.random.RandomState(seed)
    y = gen.randint(0, 2, 500)
    score = np.round(gen.rand(500) + 0.3 * y, 2)  # quantised: ties, the hard case
    w = gen.rand(500) + 0.05 if weighted else None
    ours = t_metrics.roc_auc_score(y, score, sample_weight=w)
    assert ours == j_metrics.roc_auc_score(y, score, sample_weight=w)
    assert ours == pytest.approx(sklearn.metrics.roc_auc_score(y, score, sample_weight=w), abs=1e-12)
    with pytest.raises(ValueError, match="2 classes"):
        t_metrics.roc_auc_score(np.array([1, 1, 1]), np.array([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("fast_approx", [False, True])
def test_complexity_sinc_matrix_matches_jax(fast_approx: bool) -> None:
    Z = np.random.RandomState(10).randn(12, 40) * 0.7
    Z[3, 5] = Z[3, 6]  # an exact zero difference takes the sinc's limit 1
    theirs = np.asarray(j_orff.complexity_sinc_matrix(jnp.asarray(Z), fast_approx=fast_approx))
    ours = t_orff.complexity_sinc_matrix(torch.from_numpy(Z), fast_approx=fast_approx).numpy()
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-14)


class _TorchSincORFF(t_orff.OrthogonalRandomFourierFeatures):
    @property
    def complexity_matrix(self) -> np.ndarray:
        return self.complexity_matrix_exact()


class _JaxSincORFF(j_orff.OrthogonalRandomFourierFeatures):
    @property
    def complexity_matrix(self) -> np.ndarray:
        return self.complexity_matrix_exact()


def test_exact_complexity_matrix_estimator_matches_jax() -> None:
    """A feature map whose complexity matrix is the exact sinc product takes the
    whitened-GEVD solver on both sides: γ equal, the LOO residuals and predictions at rtol
    1e-6, and the fitted loo_std_ consistent with predict_std."""
    X, y = make_regression_dataset(n=2000, seed=11)
    X, X_test, y = X[:1600], X[1600:], y[:1600]
    ours = NeoLSSVM(primal_feature_map=_TorchSincORFF(num_features=48), device="cpu").fit(X, y)
    theirs = JaxNeoLSSVM(primal_feature_map=_JaxSincORFF(num_features=48), pre_transform="host").fit(X, y)
    np.testing.assert_allclose(
        ours.primal_feature_map_.complexity_matrix, theirs.primal_feature_map_.complexity_matrix, rtol=1e-10, atol=1e-14
    )
    assert ours.primal_ and ours.pre_transform_ == "host"
    assert ours.γ_ == theirs.γ_
    np.testing.assert_allclose(ours.loo_residuals_, theirs.loo_residuals_, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(ours.predict(X_test), theirs.predict(X_test), rtol=1e-6, atol=1e-10)
    var_train = ours.predict_std(X) ** 2
    s = np.full(len(y), 1.0 / len(y))
    reconstructed = var_train + (s * var_train) ** 2 / (1 - ours.loo_leverage_)
    np.testing.assert_allclose(ours.loo_std_**2, reconstructed, rtol=1e-6)


def test_packages_export_what_the_jax_packages_export() -> None:
    """The same names under the port's (``weighted_quantile_torch`` for
    ``weighted_quantile_jax``); the host ``weighted_quantile`` stays in its submodule,
    which the package attribute keeps naming."""
    renamed = {"weighted_quantile_jax": "weighted_quantile_torch"}
    want = {renamed.get(name, name) for name in j_ops.__all__} - {"weighted_quantile"}
    assert set(t_ops.__all__) == want
    assert all(hasattr(t_ops, name) for name in t_ops.__all__)
    assert type(t_ops.weighted_quantile).__name__ == "module"
    assert set(t_models.__all__) == set(j_models.__all__)
    from neo_ls_svm_torch.models import CoherentLinearQuantileRegressor  # noqa: PLC0415
    from neo_ls_svm_torch.ops import AffineSeparator  # noqa: PLC0415

    assert AffineSeparator is t_affine.AffineSeparator
    assert CoherentLinearQuantileRegressor.__module__ == "neo_ls_svm_torch.models.cqr"


def test_trace_writes_a_trace_file(tmp_path) -> None:
    with trace(tmp_path / "trace") as profiler, annotate("neo_region"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("trace-*.json")
    names = {event.get("name") for event in json.loads(path.read_text())["traceEvents"]}
    assert "neo_region" in names
    assert any(evt.key == "aten::mm" for evt in profiler.key_averages())
