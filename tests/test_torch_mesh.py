"""The port's multi-GPU fits (``neo_ls_svm_torch.parallel.mesh``) match the JAX package's.

The port's side runs in 4 processes on the CPU, one rank each, with a gloo process group
(``_torch_mesh_worker.py``); one spawn per mesh shape computes every case, and the tests
below read its results. The JAX side runs in this process on the 8 virtual CPU devices of
``conftest.py``, on a mesh of the same shape. Both get the same NumPy operands in
float64, and are held to ``tests/test_sharding.py``'s own tolerances: the in-memory fit at
rtol 1e-7 (γ at rel 1e-12), the streaming fit at rtol 1e-6, atol 1e-12 (its LOO score at
rel 1e-9). On the CPU the port's streaming fit runs K1 and K2 through their plain
versions; the JAX side runs its Pallas kernels in interpret mode for that comparison.
Under ``precision="fast"`` the ranks record which products run under TF32 and which
``precision`` K2 is given: every mesh route must carry it, and only the sweep's products
may enter the TF32 scope (on the CPU the fit then equals the "high" fit bit for bit).
The device pre-transform runs on each rank's block of rows: with the same draws it is held
to ``device_pre_transform`` on all rows and to the JAX ``device_pre_transform`` (its draws
injected) in float64 at rtol 1e-9, its per-bin medians bit-equal with unit weights, and a
spy shows that each rank's pre-transform saw only its own rows.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.ops import affine as t_affine
from neo_ls_svm_torch.ops import pretransform_device as t_pt
from neo_ls_svm_torch.parallel import mesh as tmesh
from neo_ls_svm_tpu import NeoLSSVM as JaxNeoLSSVM
from neo_ls_svm_tpu.models import estimator as jax_est
from neo_ls_svm_tpu.models.primal import gamma_grid, primal_fit
from neo_ls_svm_tpu.ops import pretransform_device as j_pt
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures
from neo_ls_svm_tpu.parallel import mesh as jmesh

from . import _torch_mesh_worker as worker
from .conftest import make_classification_dataset, make_regression_dataset
from .test_torch_pretransform_device import PT_KW, _column_signs, _data, _jax_draws

INMEMORY = {"rtol": 1e-7}
STREAMING = {"rtol": 1e-6, "atol": 1e-12}
COMPARED = ("loo_residuals", "beta_emb", "loo_std", "residuals", "loo_errors_gammas", "loo_leverage")


def _operands(n: int, seed: int, *, classifier: bool = False, custom_c: bool = False) -> dict:
    if classifier:
        X, labels = make_classification_dataset(n=n, seed=seed)
        y = np.where(labels == "pos", 1.0, -1.0)
    else:
        X, y = make_regression_dataset(n=n, seed=seed)
    s = np.ones_like(y)
    M, b = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s).linear_map()
    case = {"X": X, "M": M, "b": b, "y": y, "s": s, "gammas": gamma_grid(np.float64), "is_classifier": classifier}
    if custom_c:
        # A nontrivial complexity matrix, normalised as the estimators do: the GEVD path.
        C = np.diag(1.0 + np.random.RandomState(seed).rand(65))
        C_n = C / (np.mean(np.abs(np.diag(C))) * (n * C.shape[0]))
        case["C"] = np.block([[C_n, np.zeros_like(C_n)], [np.zeros_like(C_n), C_n]])
    return case


def _sharded_case(route: str, n: int, seed: int, **kw) -> dict:
    return {"kind": "sharded", "route": route, "row_chunk": 64, **_operands(n, seed, **kw)}


def _estimator_case(n: int, seed: int, **kw) -> dict:
    X, y = make_regression_dataset(n=n, seed=seed)
    dtype = kw.pop("dtype", None)
    if dtype is not None:
        X, y = X.astype(dtype), y.astype(dtype)
    if kw.pop("positive", False):
        y = np.abs(y) + 10.0  # price-like positive target (conformal coverage convention)
    return {"kind": "estimator", "X": X, "y": y, **kw}


def _pretransform_case(task: str, n: int, seed: int, *, unit_weights: bool = False, jax_draws: bool = False) -> dict:
    """Rows for the sharded device pre-transform: the JAX package's draws (and its result)
    from a key, or a torch generator's seed."""
    X, y, w = _data(task, seed, n)
    if unit_weights:
        w = np.ones(n)
    kw = {**PT_KW, "num_bins": 2 if task == "classification" else 8, "is_classifier": task == "classification"}
    case = {"kind": "pretransform", "X": X, "y": y, "w": w, "kw": kw, "seed": seed}
    if jax_draws:
        key = jax.random.PRNGKey(seed)
        jx = j_pt.device_pre_transform(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), key, **kw)
        case["jax"] = {k: np.asarray(v) for k, v in jx.items()}
        ess = int(kw["edge_sample_size"] * 4 / 3) if kw["is_classifier"] else kw["edge_sample_size"]
        draws = _jax_draws(key, kw["num_bins"], ess, kw["edge_search_multiplier"])
        # pt_Z's blocks are orthonormal before the χ rescale: its squared column norms are χ².
        draws["chi"] = np.sum(case["jax"]["pt_Z"] ** 2, axis=0, keepdims=True)
        case.update(draws=draws, seed=None)
    return case


def _one_device_pretransform(case: dict) -> dict:
    """``device_pre_transform`` on all of the case's rows, with its draws or its seed."""
    generator = None
    if case["seed"] is not None:
        generator = torch.Generator()
        generator.manual_seed(case["seed"])
    X, y, w = (torch.from_numpy(case[k]) for k in ("X", "y", "w"))
    out = t_pt.device_pre_transform(X, y, w, generator, draws=case.get("draws"), **case["kw"])
    return {k: v.numpy() for k, v in out.items()}


def _assert_pretransform_close(ours: dict, theirs: dict, **tol) -> None:
    """The operands of two pre-transforms alike, whatever signs eigh gave A's columns and
    qr gave Z's: A and Z after one sign rule, and the fold from their A and Z with our signs."""
    np.testing.assert_allclose(ours["pt_shift"], theirs["pt_shift"], err_msg="shift", **tol)
    np.testing.assert_allclose(ours["pt_scale"], theirs["pt_scale"], err_msg="scale", **tol)
    signs_A = _column_signs(ours["pt_A"]) * _column_signs(theirs["pt_A"])
    signs_Z = _column_signs(ours["pt_Z"]) * _column_signs(theirs["pt_Z"])
    np.testing.assert_allclose(ours["pt_A"], theirs["pt_A"] * signs_A, err_msg="A", **tol)
    np.testing.assert_allclose(ours["pt_Z"], theirs["pt_Z"] * signs_Z, err_msg="Z", **tol)
    folded = (theirs["pt_A"] * signs_A) @ (theirs["pt_Z"] * signs_Z)
    inv_scale = 1.0 / theirs["pt_scale"][0]
    np.testing.assert_allclose(ours["pt_folded"], folded, err_msg="folded", **tol)
    np.testing.assert_allclose(ours["M"], folded * inv_scale[:, None], err_msg="M", **tol)
    np.testing.assert_allclose(ours["b"], -(theirs["pt_shift"] * inv_scale) @ folded, err_msg="b", **tol)


def _jax_sharded(case: dict, shape: tuple[int, int], **kw) -> dict:
    mesh = jmesh.make_mesh(num_data=shape[0], num_feature=shape[1])
    operands = [case[k] for k in ("X", "M", "b", "y", "s", "gammas")]
    if case["route"] == "streaming":
        fit = jmesh.sharded_primal_fit_streaming(
            mesh, *operands, case.get("C"), is_classifier=case["is_classifier"], row_chunk=case["row_chunk"], **kw
        )
    else:
        fit = jmesh.sharded_primal_fit(mesh, *operands, case.get("C"), is_classifier=case["is_classifier"])
    return {k: np.asarray(v) for k, v in fit.items()}


def _assert_fit_matches(ours: dict, theirs: dict, tol: dict) -> None:
    assert float(ours["gamma"]) == pytest.approx(float(theirs["gamma"]), rel=1e-12)
    for key in COMPARED:
        np.testing.assert_allclose(ours[key], theirs[key], err_msg=key, **tol)
    assert float(ours["loo_score"]) == pytest.approx(float(theirs["loo_score"]), rel=1e-9)


# ---------------------------------------------------------------- the three spawns


@pytest.fixture(scope="module")
def cases_41() -> dict:
    return {
        "inmemory": _sharded_case("inmemory", 1500, 41),
        "streaming": _sharded_case("streaming", 1500, 43),
        "kernels": _sharded_case("streaming", 1536, 45),
        "custom_c_inmemory": _sharded_case("inmemory", 1500, 48, custom_c=True),
        "custom_c_streaming": _sharded_case("streaming", 1500, 48, custom_c=True),
        "classifier_inmemory": _sharded_case("inmemory", 1500, 49, classifier=True),
        "classifier_streaming": _sharded_case("streaming", 1500, 49, classifier=True),
        "estimator": _estimator_case(1500, 42, persist=True),
        "estimator_auto": _estimator_case(1500, 42, mesh=False, params={"mesh": "auto"}),
        "estimator_streaming": _estimator_case(1500, 44, streaming_bytes_threshold=1),
        "conformal": _estimator_case(1500, 45, positive=True, conformal=True),
        "transfer": _estimator_case(1500, 46, params={"transfer": "bfloat16"}, expect_error=True),
        "device_pt_single": _estimator_case(1500, 45, mesh=False, params={"pre_transform": "device"}),
        "device_pt_inmemory": _estimator_case(1500, 45, params={"pre_transform": "device"}),
        "device_pt_streaming": _estimator_case(
            1500, 45, params={"pre_transform": "device"}, streaming_bytes_threshold=1
        ),
        "device_pt_single_f32": _estimator_case(
            1500, 45, mesh=False, params={"pre_transform": "device"}, dtype=np.float32
        ),
        "device_pt_inmemory_f32": _estimator_case(1500, 45, params={"pre_transform": "device"}, dtype=np.float32),
        "estimator_fast": _estimator_case(1500, 42, params={"precision": "fast"}, record=True),
        "estimator_streaming_fast": _estimator_case(
            1500, 44, params={"precision": "fast"}, streaming_bytes_threshold=1, record=True
        ),
        "device_pt_streaming_fast": _estimator_case(
            1500, 45, params={"pre_transform": "device", "precision": "fast"}, streaming_bytes_threshold=1, record=True
        ),
        "pt_weighted": _pretransform_case("regression", 1502, 11, jax_draws=True),
        "pt_classifier": _pretransform_case("classification", 1500, 12, jax_draws=True),
        "pt_unit": _pretransform_case("regression", 1502, 13, unit_weights=True),
    }


@pytest.fixture(scope="module")
def ranks_41(cases_41, tmp_path_factory) -> list[dict]:
    return worker.spawn(worker.mesh_scenarios, 4, tmp_path_factory.mktemp("mesh41"), (4, 1), cases_41)


@pytest.fixture(scope="module")
def cases_22() -> dict:
    return {
        "inmemory": _sharded_case("inmemory", 1500, 41),
        "streaming": _sharded_case("streaming", 1500, 43),
        "pt_unit": _pretransform_case("regression", 1502, 13, unit_weights=True),
    }


@pytest.fixture(scope="module")
def ranks_22(cases_22, tmp_path_factory) -> list[dict]:
    return worker.spawn(worker.mesh_scenarios, 4, tmp_path_factory.mktemp("mesh22"), (2, 2), cases_22)


@pytest.fixture(scope="module")
def cases_14() -> dict:
    spied = {**_sharded_case("streaming", 1504, 47), "kind": "spied", "row_chunk": 94}
    spied_fast = {**spied, "kind": "precision_spied", "sweep_precision": "fast"}
    return {"streaming": _sharded_case("streaming", 1500, 43), "spied": spied, "spied_fast": spied_fast}


@pytest.fixture(scope="module")
def ranks_14(cases_14, tmp_path_factory) -> list[dict]:
    return worker.spawn(worker.mesh_scenarios, 4, tmp_path_factory.mktemp("mesh14"), (1, 4), cases_14)


@pytest.fixture(scope="module")
def spawned(request) -> dict:
    """Cases and rank results of the spawn of one mesh shape, by shape."""

    def get(shape: tuple[int, int]) -> tuple[dict, list[dict]]:
        tag = f"{shape[0]}{shape[1]}"
        return request.getfixturevalue(f"cases_{tag}"), request.getfixturevalue(f"ranks_{tag}")

    return get


# ------------------------------------------------------------ solver functions


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_primal_fit_matches_jax(spawned, shape) -> None:
    cases, ranks = spawned(shape)
    theirs = _jax_sharded(cases["inmemory"], shape)
    ours = ranks[0]["inmemory"]
    assert float(ours["gamma"]) == pytest.approx(float(theirs["gamma"]), rel=1e-12)
    for key in ("loo_residuals", "beta_emb", "loo_std"):
        np.testing.assert_allclose(ours[key], theirs[key], err_msg=key, **INMEMORY)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_sharded_streaming_fit_matches_jax(spawned, shape) -> None:
    cases, ranks = spawned(shape)
    _assert_fit_matches(ranks[0]["streaming"], _jax_sharded(cases["streaming"], shape), STREAMING)


def test_streaming_kernel_path_matches_jax_pallas_kernels(cases_41, ranks_41) -> None:
    """On a (4, 1) mesh each rank runs K1 and K2 (here their plain versions) on its row
    shard; JAX runs its Pallas kernels in interpret mode on each shard."""
    case = cases_41["kernels"]
    theirs = _jax_sharded(case, (4, 1), use_pallas_gram=True, use_pallas_sweep=True, pallas_interpret=True)
    _assert_fit_matches(ranks_41[0]["kernels"], theirs, STREAMING)


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
def test_custom_complexity_matrix_matches_jax(cases_41, ranks_41, route) -> None:
    name = f"custom_c_{route}"
    _assert_fit_matches(ranks_41[0][name], _jax_sharded(cases_41[name], (4, 1)), STREAMING)


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
def test_classifier_matches_jax(cases_41, ranks_41, route) -> None:
    name = f"classifier_{route}"
    _assert_fit_matches(ranks_41[0][name], _jax_sharded(cases_41[name], (4, 1)), STREAMING)


@pytest.mark.parametrize("name", ["inmemory", "streaming", "kernels", "classifier_streaming"])
def test_every_rank_holds_the_same_whole_result(ranks_41, name) -> None:
    """Per-row outputs come back whole (n rows) and bit-equal on every rank, and so does
    every replicated output."""
    first = ranks_41[0][name]
    assert first["loo_residuals"].shape == (len(first["loo_residuals"]),)
    for other in ranks_41[1:]:
        for key, value in first.items():
            np.testing.assert_array_equal(other[name][key], value, err_msg=key)


def test_feature_axis_partitions_the_contractions(cases_14, ranks_14) -> None:
    """On a (1, 4) mesh the pass-1 Gram columns come back through one column gather of a
    (2M+1) × (2M+1)/4 block (D = 64: 131 columns padded to 132, 33 each), and every row
    chunk sums num and lev (pass 2, one column per γ) and num and σ² (pass 3) over
    ``feature``: four sums a chunk. The fit matches the single-device JAX fit."""
    case, spied = cases_14["spied"], ranks_14[0]["spied"]
    assert spied["column_gathers"] == [(131, 33)]
    chunks = 1504 // 94
    G = case["gammas"].shape[0]
    assert spied["feature_sums"] == [(94, G)] * (2 * chunks) + [(94,)] * (2 * chunks)
    operands = [case[k] for k in ("X", "M", "b", "y", "s", "gammas")]
    single = {k: np.asarray(v) for k, v in primal_fit(*operands, is_classifier=False).items()}
    assert float(spied["result"]["gamma"]) == pytest.approx(float(single["gamma"]), rel=1e-12)
    for key in COMPARED:
        np.testing.assert_allclose(spied["result"][key], single[key], err_msg=key, **STREAMING)


def test_feature_axis_runs_only_its_sweep_products_in_tf32(ranks_14) -> None:
    """Under sweep_precision="fast" the feature-axis pass 2 runs Gu_b, num and lev under
    TF32 in every row chunk, on this rank's 33 eigenvector columns (X·M and every other
    product stay IEEE, and no K2 runs); on the CPU the fit equals the "high" one."""
    for rank in ranks_14:
        fast, high = rank["spied_fast"], rank["spied"]
        G = len(high["result"]["loo_errors_gammas"])
        chunk = [((94, 130), (130, 33)), ((94, 33), (33, G)), ((94, 33), (33, G))]
        assert fast["tf32_products"] == chunk * (1504 // 94)
        assert fast["sweep_precisions"] == []
        for key, value in high["result"].items():
            np.testing.assert_array_equal(fast["result"][key], value, err_msg=key)


@pytest.mark.parametrize(
    ("name", "high"),
    [
        ("estimator_fast", "estimator"),
        ("estimator_streaming_fast", "estimator_streaming"),
        ("device_pt_streaming_fast", "device_pt_streaming"),
    ],
)
def test_fast_reaches_every_mesh_route(ranks_41, name, high) -> None:
    """precision="fast" on a (4, 1) mesh: streaming (with the host or the device
    pre-transform), each rank's K2 is called with precision="fast", and on the CPU its
    plain sweep's three products on the rank's 375 rows are the only TF32 products; in
    memory, only the two sweep contractions of each γ chunk are. The fit equals the "high"
    fit on every rank, bit for bit, as every product is IEEE on the CPU."""
    M2, G = 2 * 512 + 2, 1024
    for rank in ranks_41:
        fast, ref = rank[name], rank[high]
        if "streaming" in name:
            assert fast["sweep_precisions"] == ["fast"]
            assert fast["tf32_products"] == [((375, M2), (M2, M2)), ((375, M2), (M2, G)), ((375, M2), (M2, G))]
        else:
            assert fast["sweep_precisions"] == []
            assert fast["tf32_products"] == [((375, M2), (M2, 128))] * (2 * G // 128)
        assert fast["gamma"] == ref["gamma"]
        for key in ("loo_residuals", "loo_std", "predict", "predict_std"):
            np.testing.assert_array_equal(fast[key], ref[key], err_msg=key)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_make_mesh_is_built_once_per_group_and_shape(spawned, shape) -> None:
    """A second make_mesh of the same shape returns the first mesh: a refit makes no new
    process groups."""
    _, ranks = spawned(shape)
    assert [rank["mesh_reused"] for rank in ranks] == [True] * 4


PRETRANSFORM = {"rtol": 1e-9, "atol": 1e-12}


@pytest.mark.parametrize(
    ("shape", "name"), [((4, 1), "pt_weighted"), ((4, 1), "pt_classifier"), ((4, 1), "pt_unit"), ((2, 2), "pt_unit")]
)
def test_sharded_pretransform_matches_one_device(spawned, shape, name) -> None:
    """Each rank's pre-transform on its block, with the draws of one device (injected, or
    a generator's drawn on the first rank and sent), equals ``device_pre_transform`` on all
    rows in float64 at rtol 1e-9, and every rank holds the same bits. On (2, 2) the sums
    run over ``data`` and the two ranks of a ``feature`` group hold the same block."""
    cases, ranks = spawned(shape)
    _assert_pretransform_close(ranks[0][name]["pt"], _one_device_pretransform(cases[name]), **PRETRANSFORM)
    for other in ranks[1:]:
        for key, value in ranks[0][name]["pt"].items():
            np.testing.assert_array_equal(other[name]["pt"][key], value, err_msg=key)


@pytest.mark.parametrize("name", ["pt_weighted", "pt_classifier"])
def test_sharded_pretransform_matches_jax(cases_41, ranks_41, name) -> None:
    """The sharded pre-transform against the JAX ``device_pre_transform`` from the key
    whose draws it was given, in float64 at rtol 1e-9."""
    _assert_pretransform_close(ranks_41[0][name]["pt"], cases_41[name]["jax"], **PRETRANSFORM)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_medians_are_bit_equal_with_unit_weights(spawned, shape) -> None:
    """With unit weights every mass of the bisection is an exact integer, so the per-bin
    medians of the row blocks are one device's to the last bit."""
    cases, ranks = spawned(shape)
    case = cases["pt_unit"]
    X, y, w = (torch.from_numpy(case[k]) for k in ("X", "y", "w"))
    num_bins = case["kw"]["num_bins"]
    codes, _ = t_pt._target_codes(y, w, num_bins=num_bins, is_classifier=False)
    single = t_affine.grouped_weighted_median(X, w, codes, num_bins).numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["pt_unit"]["medians"], single)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_each_rank_pretransforms_only_its_rows(spawned, shape) -> None:
    """A spy on ``device_pre_transform``: each rank passed it exactly its block of X's
    rows (1502 rows: padded with zeros to 1504 on (4, 1), blocks of 376; blocks of 751 on
    (2, 2))."""
    cases, ranks = spawned(shape)
    X = cases["pt_unit"]["X"]
    X_pad = np.vstack([X, np.zeros((tmesh.required_padding(len(X), shape[0]), X.shape[1]))])
    per = len(X_pad) // shape[0]
    for index, rank in enumerate(ranks):
        lo = (index // shape[1]) * per
        assert rank["pt_unit"]["rows"] == (lo, lo + per)
        (seen,) = rank["pt_unit"]["X_seen"]
        np.testing.assert_array_equal(seen, X_pad[lo : lo + per])


@pytest.mark.parametrize("num_data", [1, 2, 3, 4, 8])
def test_padding_and_row_chunk_match_jax(num_data) -> None:
    for n in (1, 7, 1500, 1504, 16384, 100_003):
        assert tmesh.required_padding(n, num_data) == jmesh.required_padding(n, num_data)
        for row_chunk in (64, 94, 16384, 32768):
            got = tmesh.streaming_row_chunk(n, num_data, row_chunk)
            assert got == jmesh.streaming_row_chunk(n, num_data, row_chunk)


# ------------------------------------------------------------------- estimator


@pytest.fixture(scope="module")
def jax_models(cases_41) -> dict:
    mesh = jmesh.make_mesh(num_data=4, num_feature=1)
    models = {}
    for name in ("estimator", "conformal"):
        case = cases_41[name]
        models[name] = JaxNeoLSSVM(mesh=mesh).fit(case["X"], case["y"])
    case = cases_41["estimator_streaming"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_est, "STREAMING_BYTES_THRESHOLD", 1)  # force per-chip streaming
        models["estimator_streaming"] = JaxNeoLSSVM(mesh=mesh).fit(case["X"], case["y"])
    return models


@pytest.mark.parametrize(("name", "rtol"), [("estimator", 1e-7), ("estimator_streaming", 1e-6)])
def test_estimator_mesh_fit_matches_jax(cases_41, ranks_41, jax_models, name, rtol) -> None:
    """NeoLSSVM(mesh=...) on the host pre-transform, in memory and streaming above the
    per-rank working-set threshold, against the JAX estimator on the same mesh shape."""
    ours, theirs = ranks_41[0][name], jax_models[name]
    assert ours["mesh_shape"] == (4, 1)
    assert ours["pre_transform"] == theirs.pre_transform_ == "host"
    assert ours["gamma"] == pytest.approx(theirs.γ_, rel=1e-12)
    np.testing.assert_allclose(ours["loo_residuals"], theirs.loo_residuals_, rtol=rtol)
    np.testing.assert_allclose(ours["predict"], theirs.predict(cases_41[name]["X"][:100]), rtol=rtol)


def test_mesh_fit_conformal_serving_matches_jax(cases_41, ranks_41, jax_models) -> None:
    X = cases_41["conformal"]["X"][:100]
    ours, theirs = ranks_41[0]["conformal"], jax_models["conformal"]
    q_jax = np.asarray(theirs.predict_quantiles(X, quantiles=(0.025, 0.5, 0.975)))
    np.testing.assert_allclose(ours["quantiles"], q_jax, rtol=1e-6, atol=1e-9)
    iv_jax = np.asarray(theirs.predict_interval(X, coverage=0.9))
    np.testing.assert_allclose(ours["interval"], iv_jax, rtol=1e-6, atol=1e-9)
    assert np.all(np.diff(ours["quantiles"], axis=1) >= -1e-9)


def test_mesh_auto_in_a_world_of_four_matches_an_explicit_mesh(ranks_41) -> None:
    """mesh="auto" resolves to the (4, 1) mesh already built on this group, not a new one."""
    auto, explicit = ranks_41[0]["estimator_auto"], ranks_41[0]["estimator"]
    assert auto["mesh_shape"] == explicit["mesh_shape"] == (4, 1)
    assert auto["same_mesh"]
    assert auto["gamma"] == explicit["gamma"]
    np.testing.assert_array_equal(auto["loo_residuals"], explicit["loo_residuals"])


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
def test_device_pretransform_mesh_route_matches_single_device(ranks_41, route) -> None:
    """The ranks run the device pre-transform on their own rows with the draws of the
    single-device route's seed (drawn on the first rank and sent): M and b equal to the
    single-device fit's up to the order of the deviations' sums (rtol 1e-12; the medians
    are exact with unit weights), and γ equal."""
    ours, single = ranks_41[0][f"device_pt_{route}"], ranks_41[0]["device_pt_single"]
    assert ours["pre_transform"] == single["pre_transform"] == "device"
    np.testing.assert_allclose(ours["M_map"], single["M_map"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours["b_map"], single["b_map"], rtol=1e-12, atol=1e-12)
    assert ours["gamma"] == single["gamma"]
    np.testing.assert_allclose(ours["predict"], single["predict"], rtol=1e-6, atol=1e-12)
    for other in ranks_41[1:]:
        np.testing.assert_array_equal(other[f"device_pt_{route}"]["loo_residuals"], ours["loo_residuals"])


def test_device_pretransform_mesh_route_is_bit_equal_in_f32(ranks_41) -> None:
    """In f32 the deviations' float64 sums round to one device's σ, and every other input
    of M and b is exact or replicated: the ranks' M and b equal the single-device fit's to
    the bit. (The solver after them sums its f32 Gram in the ranks' order, so γ may not.)"""
    ours, single = ranks_41[0]["device_pt_inmemory_f32"], ranks_41[0]["device_pt_single_f32"]
    assert ours["pre_transform"] == single["pre_transform"] == "device"
    assert ours["M_map"].dtype == single["M_map"].dtype == np.float32
    np.testing.assert_array_equal(ours["M_map"], single["M_map"])
    np.testing.assert_array_equal(ours["b_map"], single["b_map"])
    for other in ranks_41[1:]:
        np.testing.assert_array_equal(other["device_pt_inmemory_f32"]["M_map"], ours["M_map"])


def test_transfer_narrowing_with_a_mesh_raises(ranks_41) -> None:
    assert "mesh route" in ranks_41[0]["transfer"]["error"]


def test_mesh_fitted_model_persists_as_a_single_device_model(cases_41, ranks_41) -> None:
    """Pickle and state dict of a rank's mesh-fitted model hold mesh=None and no mesh_.
    Restored on the rank, they predict bit for bit what the model does; restored in this
    process, which has no process group, they predict the same up to the summation order
    of another process's BLAS."""
    fitted = ranks_41[0]["estimator"]
    want = (fitted["predict"], fitted["predict_std"])
    for how, got in fitted["restored"].items():
        for ours, theirs in zip(got, want):
            np.testing.assert_array_equal(ours, theirs, err_msg=how)
    unpickled = pickle.loads(fitted["pickle"])
    state = fitted["state_dict"]
    assert unpickled.mesh is None and "mesh_" not in vars(unpickled)
    assert state["params"]["mesh"] is None and "mesh_" not in state["attrs"]
    X = cases_41["estimator"]["X"][:100]
    for model in (unpickled, NeoLSSVM.from_state_dict(state, device="cpu")):
        np.testing.assert_allclose(model.predict(X), want[0], rtol=1e-12)
        np.testing.assert_allclose(model.predict_std(X), want[1], rtol=1e-12)


def test_mesh_auto_without_a_process_group_fits_on_one_device() -> None:
    X, y = make_regression_dataset(n=1500, seed=49)
    model = NeoLSSVM(device="cpu", mesh="auto").fit(X, y)
    assert model.mesh_ is None
    assert model.score(X, y) > 0.5


def test_invalid_mesh_value_raises() -> None:
    X, y = make_regression_dataset(n=1500, seed=48)
    with pytest.raises(ValueError, match="mesh"):
        NeoLSSVM(device="cpu", mesh="all-devices").fit(X, y)


def test_make_mesh_needs_a_process_group() -> None:
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(device_type="cpu")
