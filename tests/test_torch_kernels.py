"""The plain versions of the port's CUDA kernels match the JAX package's Pallas kernels.

The same float64 operands (made from a seed) go through the Pallas kernel in interpret
mode, the plain-XLA reference, and the port's plain PyTorch version, at rtol 1e-10. On
CPU tensors the wrappers must take the plain version and launch nothing. (The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds them against these
plain versions there.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_ls_svm_torch.ops.cuda import gram as tgram
from neo_ls_svm_torch.ops.cuda import sweep as tsweep
from neo_ls_svm_tpu.models.primal import embed_from_gram_blocks, gamma_grid
from neo_ls_svm_tpu.ops.pallas.gram import (
    augmented_gram_reference,
    fused_augmented_gram,
    w_basis_from_augmented,
)
from neo_ls_svm_tpu.ops.pallas.sweep import fused_loo_sweep

RTOL = 1e-10
N, d, D = 512, 8, 64


def _operands(seed: int, classifier: bool = False) -> dict[str, np.ndarray]:
    gen = np.random.RandomState(seed)
    X = gen.randn(N, d)
    M_map = gen.randn(d, D)
    b_map = gen.uniform(0, 2 * np.pi, (1, D))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * gen.randn(N)
    if classifier:
        y = np.where(y > 0, 1.0, -1.0)
    w = gen.rand(N) + 0.25
    s = w / w.sum()
    return {"X": X, "M_map": M_map, "b_map": b_map, "y": y, "s": s, "s2": s * s}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _sweep_operands(ops: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Qs, k and r_all from a real eigendecomposition of the operands' Gram."""
    G_aug = np.asarray(
        augmented_gram_reference(*(jnp.asarray(ops[k]) for k in ("X", "M_map", "b_map", "s2", "y")))
    )
    G_W, b_vec = (np.asarray(a) for a in w_basis_from_augmented(jnp.asarray(G_aug), D))
    M = D + 1
    inv_c0 = float(N * M)
    lam, Q = np.linalg.eigh(inv_c0 * np.asarray(embed_from_gram_blocks(jnp.asarray(G_W), M)))
    Qs = np.concatenate([np.ones(M), -np.ones(M)])[:, None] * Q
    r_all = 1.0 / (gamma_grid(np.float64)[None, :] + lam[:, None])
    return {"Qs": Qs, "r_all": r_all, "k": Qs.T @ b_vec, "inv_c0": inv_c0}


def test_gram_plain_matches_reference_and_pallas() -> None:
    ops = _operands(81)
    args = [ops[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    reference = np.asarray(augmented_gram_reference(*map(jnp.asarray, args)))
    pallas = np.asarray(fused_augmented_gram(*map(jnp.asarray, args), block_rows=256, interpret=True))
    ours = tgram.gram_plain(*map(_t, args)).numpy()
    np.testing.assert_allclose(ours, reference, rtol=RTOL, atol=RTOL * np.abs(reference).max())
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=RTOL * np.abs(pallas).max())


def test_w_basis_from_augmented_matches_jax() -> None:
    G_aug = np.random.RandomState(82).randn(2 * D + 2, 2 * D + 2)
    theirs = w_basis_from_augmented(jnp.asarray(G_aug), D)
    ours = tgram.w_basis_from_augmented(_t(G_aug), D)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_sweep_plain_matches_pallas(task: str) -> None:
    is_classifier = task == "classification"
    ops = _operands(83, classifier=is_classifier)
    sw = _sweep_operands(ops)
    names = ("X", "M_map", "b_map", "y", "s", "s2")
    pallas_err, pallas_obj = fused_loo_sweep(
        *(jnp.asarray(ops[k]) for k in names),
        *(jnp.asarray(sw[k]) for k in ("Qs", "r_all", "k")),
        block_rows=128,
        is_classifier=is_classifier,
        inv_c0_static=sw["inv_c0"],
        interpret=True,
    )
    err, obj = tsweep.sweep_plain(
        *(_t(ops[k]) for k in names),
        *(_t(sw[k]) for k in ("Qs", "r_all", "k")),
        is_classifier=is_classifier,
        inv_c0=sw["inv_c0"],
    )
    np.testing.assert_allclose(err.numpy(), np.asarray(pallas_err), rtol=RTOL)
    np.testing.assert_allclose(obj.numpy(), np.asarray(pallas_obj), rtol=RTOL)


def test_wrappers_route_cpu_tensors_to_plain_versions(monkeypatch) -> None:
    monkeypatch.setattr(tgram, "launches", 0)
    monkeypatch.setattr(tsweep, "launches", 0)
    ops = {k: _t(v) for k, v in _operands(84).items()}
    sw = _sweep_operands({k: v.numpy() for k, v in ops.items()})
    gram_args = [ops[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    torch.testing.assert_close(
        tgram.fused_augmented_gram(*gram_args), tgram.gram_plain(*gram_args), rtol=0, atol=0
    )
    sweep_args = [ops[k] for k in ("X", "M_map", "b_map", "y", "s", "s2")]
    sweep_args += [_t(sw[k]) for k in ("Qs", "r_all", "k")]
    kwargs = {"is_classifier": False, "inv_c0": sw["inv_c0"]}
    for a, b in zip(tsweep.fused_loo_sweep(*sweep_args, **kwargs), tsweep.sweep_plain(*sweep_args, **kwargs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tgram.launches == 0
    assert tsweep.launches == 0


def test_wrappers_reject_other_devices() -> None:
    X = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgram.fused_augmented_gram(X, X, X, X, X)
