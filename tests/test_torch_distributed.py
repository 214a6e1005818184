"""The port's multi-process set-up (``neo_ls_svm_torch.parallel.distributed``).

Two real processes form a gloo process group on the CPU through ``initialize_distributed``,
build the host-major mesh and run both sharded fits SPMD-style on the full data; their
replicated outputs must match a single-process JAX oracle at ``tests/test_multiprocess.py``'s
tolerances. The divisibility errors of ``make_multihost_mesh`` are raised inside that
world (``LOCAL_WORLD_SIZE`` set as a launcher would set it).
"""

import numpy as np
import pytest
import torch.distributed as dist

from neo_ls_svm_torch.parallel.distributed import initialize_distributed
from neo_ls_svm_tpu.models.primal import gamma_grid, primal_fit
from neo_ls_svm_tpu.ops.orff import OrthogonalRandomFourierFeatures

from . import _torch_mesh_worker as worker


def _problem() -> dict:
    """Deterministic data, as ``tests/test_multiprocess.py`` makes it."""
    gen = np.random.RandomState(41)
    X = gen.randn(1536, 8)
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.25 * np.abs(X[:, 3]) + 0.1 * X[:, 4] + 0.1 * gen.randn(1536)
    s = np.ones_like(y)
    M, b = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s).linear_map()
    return {"X": X, "M": M, "b": b, "y": y, "s": s, "gammas": gamma_grid(np.float64)}


@pytest.fixture(scope="module")
def problem() -> dict:
    return _problem()


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory) -> list[dict]:
    return worker.spawn(worker.distributed_scenario, 2, tmp_path_factory.mktemp("world2"), problem)


@pytest.fixture(scope="module")
def oracle(problem) -> dict:
    operands = [problem[k] for k in ("X", "M", "b", "y", "s", "gammas")]
    return {k: np.asarray(v) for k, v in primal_fit(*operands, is_classifier=False).items()}


def test_initialize_distributed_without_arguments_is_a_no_op() -> None:
    assert initialize_distributed() is False
    assert not dist.is_initialized()


def test_initialize_distributed_forms_the_group_once(ranks) -> None:
    for rank in ranks:
        assert rank["first_call"] is True
        assert rank["second_call"] is False  # idempotent: the group exists already
        assert rank["world_size"] == 2
        assert rank["backend"] == "gloo"
        assert rank["mesh_shape"] == (2, 1)


@pytest.mark.parametrize("route", ["inmemory", "streaming"])
def test_two_process_sharded_fit_matches_single_process(ranks, oracle, route) -> None:
    for rank in ranks:
        got = rank[route]
        assert float(got["gamma"]) == pytest.approx(float(oracle["gamma"]), rel=1e-12), route
        assert float(got["loo_score"]) == pytest.approx(float(oracle["loo_score"]), rel=1e-9), route
        np.testing.assert_allclose(got["beta_emb"], oracle["beta_emb"], rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(got["loo_residuals"], oracle["loo_residuals"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize(("name", "match"), [("uneven", "unevenly"), ("indivisible", "divisible")])
def test_multihost_mesh_validates_divisibility(ranks, name, match) -> None:
    for rank in ranks:
        assert match in rank["errors"][name]
