"""The port's on-device pre-transform against the JAX package's, on the CPU in float64.

The same NumPy inputs, made from a seed, go through each JAX function and its counterpart:
``weighted_quantile_torch`` (rtol 1e-12), ``grouped_weighted_median`` and
``_normalizer_stats_device`` (rtol 1e-10; float32 inputs at 1e-5), ``_target_codes`` (codes
equal, totals at 1e-12) and ``device_pre_transform`` (rtol 1e-8). ``jax.random`` cannot be
reproduced by a ``torch.Generator``, so the JAX draws are made from the same key, in the JAX
function's key order, and injected through ``draws``; the χ² row, whose degrees of freedom
depend on the data, is read back from the JAX result as the squared column norms of
``pt_Z``. ``eigh``'s eigenvector signs and ``qr``'s column signs are free, so A and Z are
held after one sign rule applied to both sides (each column's entry of largest magnitude is
made positive), A·Aᵀ is held as it is, and ``M`` and ``b`` are held against the fold of the
JAX A and Z with the port's column signs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.ops import affine as t_affine
from neo_ls_svm_torch.ops import pretransform_device as t_pt
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile_torch
from neo_ls_svm_tpu.ops import affine as j_affine
from neo_ls_svm_tpu.ops import pretransform_device as j_pt
from neo_ls_svm_tpu.ops.weighted_quantile import weighted_quantile_jax

# The suite runs several worker processes on a few cores: more intra-op threads than that
# only contend (these shapes are small).
torch.set_num_threads(2)

N, D_IN, D_FEAT = 3000, 6, 64
PT_KW = {"num_features": D_FEAT, "edge_sample_size": 384, "edge_search_multiplier": 4, "rank_threshold": 2e-2}


def _data(task: str = "regression", seed: int = 0, n: int = N) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    gen = np.random.RandomState(seed)
    X = gen.randn(n, D_IN)
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.25 * np.abs(X[:, 3]) + 0.1 * gen.randn(n)
    if task == "classification":
        y = np.where(y > np.median(y), 1.0, -1.0)
    w = gen.rand(n) + 0.25
    w[gen.choice(n, 40, replace=False)] = 0.0
    return X, y, w


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a copy: arrays that come from JAX are read-only


# ---------------------------------------------------------------- weighted quantile


def _quantile_case(case: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    gen = np.random.RandomState(3)
    q = np.array([0.0, 0.125, 0.3, 0.5, 0.875, 1.0])
    if case == "vector":
        return gen.randn(501), gen.rand(501) + 0.1, q, 0
    if case == "ties_and_zero_weights":
        a = np.round(gen.randn(400) * 2) / 2  # many tied values
        w = gen.rand(400)
        w[::7] = 0.0
        return a, w, q, 0
    if case == "matrix_axis0":
        return gen.randn(200, 5), gen.rand(200, 1) + 0.1, q, 0
    if case == "matrix_axis1":
        return gen.randn(4, 300), gen.rand(4, 300), np.array([0.5]), 1
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["vector", "ties_and_zero_weights", "matrix_axis0", "matrix_axis1"])
def test_weighted_quantile_torch_matches_jax(case: str) -> None:
    a, w, q, axis = _quantile_case(case)
    theirs = np.asarray(weighted_quantile_jax(jnp.asarray(a), jnp.asarray(w), jnp.asarray(q), axis=axis))
    ours = weighted_quantile_torch(_t(a), _t(w), _t(q), axis=axis).numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=0)


def test_weighted_quantile_torch_takes_a_scalar_q() -> None:
    a, w, _, _ = _quantile_case("vector")
    theirs = np.asarray(weighted_quantile_jax(jnp.asarray(a), jnp.asarray(w), 0.5))
    np.testing.assert_allclose(weighted_quantile_torch(_t(a), _t(w), 0.5).numpy(), theirs, rtol=1e-12)


# ---------------------------------------------------------- normalizer statistics


def _stats_case(case: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, float]:
    """X, w, codes, num_bins and the tolerance of one case."""
    gen = np.random.RandomState(5)
    X, _, w = _data(seed=5)
    num_bins, rtol = 8, 1e-10
    codes = gen.randint(0, num_bins, N).astype(np.int32)
    if case == "empty_bin":
        codes[codes == 3] = 4  # bin 3 has no mass
    elif case == "tied_values":
        X = np.round(X * 2) / 2
    elif case == "uniform_weights":
        w = np.ones(N)
    elif case == "float32":
        X, w, rtol = X.astype(np.float32), w.astype(np.float32), 1e-5
    codes[w == 0] = num_bins
    return X, w, codes, num_bins, rtol


STATS_CASES = ["float64", "empty_bin", "tied_values", "uniform_weights", "float32"]


@pytest.mark.parametrize("case", STATS_CASES)
def test_grouped_weighted_median_matches_jax(case: str) -> None:
    X, w, codes, num_bins, rtol = _stats_case(case)
    theirs = np.asarray(j_affine.grouped_weighted_median(jnp.asarray(X), jnp.asarray(w), jnp.asarray(codes), num_bins))
    ours = t_affine.grouped_weighted_median(_t(X), _t(w), _t(codes), num_bins).numpy()
    assert ours.dtype == X.dtype
    populated = [b for b in range(num_bins) if np.any(codes == b)]
    # The columns have unit scale, and a float32 median carries the rounding of the bin's
    # float32 mass whatever its own size: atol is the same fraction of that scale.
    np.testing.assert_allclose(ours[populated], theirs[populated], rtol=rtol, atol=rtol)
    # The median of a bin is the host weighted quantile's, up to the tie convention.
    if case == "float64":
        from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile

        rows = codes == 2
        host = weighted_quantile(X[rows], w[rows][:, None], 0.5, axis=0)
        np.testing.assert_allclose(ours[2], np.ravel(host), rtol=1e-10)


@pytest.mark.parametrize("case", STATS_CASES)
def test_normalizer_stats_device_matches_jax(case: str) -> None:
    X, w, codes, num_bins, rtol = _stats_case(case)
    totals = np.array([w[codes == b].sum() for b in range(num_bins)], X.dtype)
    theirs = j_affine._normalizer_stats_device(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(codes), jnp.asarray(totals), num_bins=num_bins
    )
    ours = t_affine._normalizer_stats_device(_t(X), _t(w), _t(codes), _t(totals), num_bins=num_bins)
    for a, b, name in zip(ours, theirs, ("shift", "scale")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=rtol, err_msg=name)


@pytest.mark.parametrize("case", ["float64", "float32"])
def test_normalizer_deviation_blocks_change_no_bit(case: str, monkeypatch) -> None:
    """The deviations' float64 sums taken a few rows at a time round to the σ of one
    block (float32), and stay within 1e-13 of it (float64)."""
    X, w, codes, num_bins, _ = _stats_case(case)
    totals = _t(np.array([w[codes == b].sum() for b in range(num_bins)], X.dtype))
    whole = t_affine._normalizer_stats_device(_t(X), _t(w), _t(codes), totals, num_bins=num_bins)
    monkeypatch.setattr(t_affine, "DEVIATION_ROWS", 7)
    blocks = t_affine._normalizer_stats_device(_t(X), _t(w), _t(codes), totals, num_bins=num_bins)
    for a, b, name in zip(blocks, whole, ("shift", "scale")):
        if case == "float32":
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_int_round_trip_keeps_order(dtype) -> None:
    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], dtype)
    ordered = t_affine._float_to_ordered_int(_t(x))
    theirs = np.asarray(j_affine._float_to_ordered_int(jnp.asarray(x)))
    np.testing.assert_array_equal(ordered.numpy(), theirs)
    assert np.all(np.diff(ordered.numpy().astype(object)) >= 0)
    back = t_affine._ordered_int_to_float(ordered, _t(x).dtype).numpy()
    np.testing.assert_array_equal(back, x)


# --------------------------------------------------------------------- the stages


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_target_codes_match_jax(task: str) -> None:
    _, y, w = _data(task)
    kw = {"num_bins": 2 if task == "classification" else 8, "is_classifier": task == "classification"}
    codes_j, totals_j = j_pt._target_codes(jnp.asarray(y), jnp.asarray(w), **kw)
    codes_t, totals_t = t_pt._target_codes(_t(y), _t(w), **kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(totals_t.numpy(), np.asarray(totals_j), rtol=1e-12)
    assert np.all(codes_t.numpy()[w == 0] == kw["num_bins"]), "zero-weight rows carry the exclusion code"


def test_sample_rows_and_sq_dists_match_jax() -> None:
    _, _, w = _data()
    cum = np.cumsum(w * (np.arange(N) % 3 == 0))
    key = jax.random.PRNGKey(7)
    theirs = np.asarray(j_pt._sample_rows(key, jnp.asarray(cum), 500))
    u = np.asarray(jax.random.uniform(key, (500,), dtype=jnp.float64))
    ours = t_pt._sample_rows(_t(u), _t(cum)).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert np.all(w[ours] > 0) and np.all(ours % 3 == 0), "only rows with mass are drawn"
    gen = np.random.RandomState(8)
    A, B = gen.randn(30, D_IN), gen.randn(50, D_IN)
    np.testing.assert_allclose(
        t_pt._sq_dists(_t(A), _t(B)).numpy(), np.asarray(j_pt._sq_dists(jnp.asarray(A), jnp.asarray(B))), rtol=1e-12
    )


def _jax_draws(key: jax.Array, num_bins: int, ess: int, multiplier: int) -> dict[str, np.ndarray]:
    """The uniform and Gaussian draws of the JAX ``device_pre_transform``, in its key order."""
    keys = jax.random.split(key, 3 * num_bins + 2)
    m = ess * multiplier

    def uniforms(offset: int, num: int) -> np.ndarray:
        return np.stack(
            [np.asarray(jax.random.uniform(keys[3 * b + offset], (num,), dtype=jnp.float64)) for b in range(num_bins)]
        )

    return {
        "bin_sample": uniforms(0, ess),
        "complement": uniforms(1, m),
        "bin_pool": uniforms(2, m),
        "Z": np.asarray(jax.random.normal(keys[-2], (num_bins * D_IN, D_FEAT), jnp.float64)),
    }


def _column_signs(A: np.ndarray) -> np.ndarray:
    """+1 or −1 per column: the sign of its entry of largest magnitude (+1 for a zero column)."""
    signs = np.sign(A[np.argmax(np.abs(A), axis=0), np.arange(A.shape[1])])
    signs[signs == 0] = 1.0
    return signs


def _both(task: str, X: np.ndarray, y: np.ndarray, w: np.ndarray) -> tuple[dict, dict]:
    is_classifier = task == "classification"
    num_bins = 2 if is_classifier else 8
    kw = {**PT_KW, "num_bins": num_bins, "is_classifier": is_classifier}
    key = jax.random.PRNGKey(42)
    theirs = {
        k: np.asarray(v)
        for k, v in j_pt.device_pre_transform(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), key, **kw).items()
    }
    ess = int(384 * 4 / 3) if is_classifier else 384
    draws = _jax_draws(key, num_bins, ess, 4)
    # pt_Z's blocks are orthonormal before the χ rescale: its squared column norms are χ².
    draws["chi"] = np.sum(theirs["pt_Z"] ** 2, axis=0, keepdims=True)
    ours = t_pt.device_pre_transform(_t(X), _t(y), _t(w), None, draws=draws, **kw)
    return {k: v.numpy() for k, v in ours.items()}, theirs


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_device_pre_transform_matches_jax_with_injected_draws(task: str) -> None:
    ours, theirs = _both(task, *_data(task))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
    tol = {"rtol": 1e-8, "atol": 1e-10}
    np.testing.assert_allclose(ours["pt_shift"], theirs["pt_shift"], **tol)
    np.testing.assert_allclose(ours["pt_scale"], theirs["pt_scale"], **tol)
    # The separator, whatever signs eigh gave its columns: A·Aᵀ carries the edges and λ².
    A_t, A_j = ours["pt_A"], theirs["pt_A"]
    np.testing.assert_allclose(A_t @ A_t.T, A_j @ A_j.T, **tol)
    kept_t, kept_j = np.any(A_t != 0, axis=0), np.any(A_j != 0, axis=0)
    np.testing.assert_array_equal(kept_t, kept_j)  # the rank cut, column by column
    assert 0 < kept_t.sum() <= A_t.shape[1]
    # Every kept column is a unit vector times λ.
    np.testing.assert_allclose(np.linalg.norm(A_t[:, kept_t], axis=0), np.linalg.norm(A_j[:, kept_j], axis=0), **tol)
    signs_A = _column_signs(A_t) * _column_signs(A_j)
    np.testing.assert_allclose(A_t, A_j * signs_A, **tol)
    Z_t, Z_j = ours["pt_Z"], theirs["pt_Z"]
    np.testing.assert_allclose(np.sum(Z_t**2, axis=0), np.sum(Z_j**2, axis=0), **tol)
    signs_Z = _column_signs(Z_t) * _column_signs(Z_j)
    np.testing.assert_allclose(Z_t, Z_j * signs_Z, **tol)
    # The fold, from the JAX A and Z with the port's column signs.
    folded = (A_j * signs_A) @ (Z_j * signs_Z)
    inv_scale = 1.0 / theirs["pt_scale"][0]
    np.testing.assert_allclose(ours["pt_folded"], folded, **tol)
    np.testing.assert_allclose(ours["M"], folded * inv_scale[:, None], **tol)
    np.testing.assert_allclose(ours["b"], -(theirs["pt_shift"] * inv_scale) @ folded, **tol)
    # U = X·M + b is (X − shift)/scale · A·Z.
    X = _data(task)[0][:10]
    np.testing.assert_allclose(
        X @ ours["M"] + ours["b"], ((X - ours["pt_shift"]) / ours["pt_scale"]) @ ours["pt_folded"], **tol
    )


def test_degenerate_one_bin_target_gives_the_identity_metric() -> None:
    """More than 7/8 of the mass on one target value: one populated bin, so shift 0, scale 1
    and A = [I | 0], as in the JAX package."""
    X, _, w = _data()
    y = np.zeros(N)
    y[:10] = np.arange(10.0) + 1.0
    ours, theirs = _both("regression", X, y, w)
    np.testing.assert_array_equal(ours["pt_shift"], np.zeros((1, D_IN)))
    np.testing.assert_array_equal(ours["pt_scale"], np.ones((1, D_IN)))
    np.testing.assert_array_equal(ours["pt_A"], np.hstack([np.eye(D_IN), np.zeros((D_IN, 7 * D_IN))]))
    np.testing.assert_allclose(ours["M"], theirs["M"], rtol=1e-8, atol=1e-10)


def _own(X, y, w, seed: int, **kw) -> dict[str, np.ndarray]:
    generator = torch.Generator(device="cpu")
    generator.manual_seed(seed)
    out = t_pt.device_pre_transform(
        _t(X), _t(y), _t(w), generator, num_bins=8, is_classifier=False, **{**PT_KW, **kw}
    )
    return {k: v.numpy() for k, v in out.items()}


def test_same_generator_seed_gives_the_same_map() -> None:
    X, y, w = _data()
    first, again, other = _own(X, y, w, 42), _own(X, y, w, 42), _own(X, y, w, 43)
    np.testing.assert_array_equal(first["M"], again["M"])
    np.testing.assert_array_equal(first["b"], again["b"])
    assert np.max(np.abs(first["M"] - other["M"])) > 1e-3


def test_zero_weight_rows_change_nothing() -> None:
    """Absurd rows of weight 0, with targets beyond every real one, leave the map as it was:
    their weight excludes them from the bins, the medians and the edge samples."""
    X, y, w = _data()
    gen = np.random.RandomState(9)
    at = np.sort(gen.choice(N, 60, replace=False))
    X_p = np.insert(X, at, 1e6, axis=0)
    y_p = np.insert(y, at, 1e9)
    w_p = np.insert(w, at, 0.0)
    clean, poisoned = _own(X, y, w, 42), _own(X_p, y_p, w_p, 42)
    for k in ("pt_shift", "pt_scale", "M", "b"):
        np.testing.assert_allclose(poisoned[k], clean[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_own_chi_draw_has_the_kept_rank_as_degrees_of_freedom() -> None:
    """Without injected draws the χ² row is a masked sum of squared normals: the mean squared
    column norm of Z is the count of kept columns of A (a loose statistical gate), and a plain
    random-Fourier map keeps its Gaussian draw."""
    X, y, w = _data()
    out = _own(X, y, w, 1, num_features=2048)
    kept = int(np.any(out["pt_A"] != 0, axis=0).sum())
    chi = np.sum(out["pt_Z"] ** 2, axis=0)
    assert abs(chi.mean() - kept) < 5 * np.sqrt(2 * kept / chi.size)
    plain = _own(X, y, w, 1, num_features=2048, orthogonal=False)
    assert abs(np.mean(plain["pt_Z"] ** 2) - 1.0) < 0.02


@pytest.mark.parametrize(
    "function", [t_pt.device_pre_transform, t_affine.grouped_weighted_median, t_affine._normalizer_stats_device]
)
def test_no_host_read_of_a_tensor_value(function) -> None:
    """The device pre-transform is one stream of device work: its source has no call that
    reads a tensor's value on the host."""
    source = inspect.getsource(function)
    for call in (".item(", ".cpu(", ".numpy(", ".tolist(", "bool(", "float(t", "int(t", ".nonzero(", "torch.unique("):
        assert call not in source, f"{function.__name__} calls {call}"


@pytest.mark.parametrize("orthogonal", [True, False])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_generator_draws_are_the_draw_functions(task: str, orthogonal: bool) -> None:
    """A generator-driven pre-transform equals the same call given the inputs that
    ``draw_pretransform_inputs`` draws from that seed, bit for bit, and leaves the generator
    where that function does. The draw order is the one the pre-transform has always
    consumed: per bin its edge sample, complement and pool uniforms, then Z, then the χ
    normals (orthogonal maps only)."""
    X, y, w = _data(task)
    is_classifier = task == "classification"
    kw = {**PT_KW, "num_bins": 2 if is_classifier else 8, "is_classifier": is_classifier, "orthogonal": orthogonal}
    generators = [torch.Generator().manual_seed(42) for _ in range(3)]
    from_generator = t_pt.device_pre_transform(_t(X), _t(y), _t(w), generators[0], **kw)
    shapes = t_pt.draw_shapes(D_IN, **{k: v for k, v in kw.items() if k != "rank_threshold"})
    draws = t_pt.draw_pretransform_inputs(generators[1], shapes, torch.float64, torch.device("cpu"))
    injected = t_pt.device_pre_transform(_t(X), _t(y), _t(w), None, draws=draws, **kw)
    for key, value in from_generator.items():
        np.testing.assert_array_equal(injected[key].numpy(), value.numpy(), err_msg=key)
    assert torch.equal(generators[0].get_state(), generators[1].get_state())
    # The same draws, call by call, in the order written out.
    ess, m = shapes["bin_sample"][1], shapes["complement"][1]
    gen = generators[2]
    rows = [[torch.rand(k, generator=gen, dtype=torch.float64) for k in (ess, m, m)] for _ in range(kw["num_bins"])]
    for i, name in enumerate(("bin_sample", "complement", "bin_pool")):
        np.testing.assert_array_equal(draws[name].numpy(), torch.stack([r[i] for r in rows]).numpy(), err_msg=name)
    for name in ("Z", "chi_normals")[: 1 + orthogonal]:
        again = torch.randn(shapes[name], generator=gen, dtype=torch.float64)
        np.testing.assert_array_equal(draws[name].numpy(), again.numpy(), err_msg=name)
    assert sorted(draws) == sorted(shapes)
