"""The ``feature_sum`` hook of the plain passes 2 and 3 (``ops/cuda/sweep.py::sweep_plain``,
``ops/cuda/pass3.py::pass3_plain``), as the mesh's feature axis calls them: each rank holds
a block of the eigenbasis's columns, and the hook completes num and lev (pass 2), num and σ²
(pass 3) over the blocks right after their contraction.

The ranks are stood in for in one process: each block's call runs once with its partials
recorded, hook call by hook call, then once more with each hook call given the sum of every
block's partial at that call. Over 2 and 4 column blocks (the last of four padded with zero
columns) every block's answer equals the whole-column call's, in float64 at rtol 1e-12. This
file imports no JAX.
"""

from collections.abc import Callable, Sequence

import numpy as np
import pytest
import torch

from neo_ls_svm_torch.models import primal
from neo_ls_svm_torch.ops.cuda import gram, pass3, sweep

# 2M = 50 columns: 2 blocks of 25, or 4 blocks of 13 with two zero columns; three row
# chunks, the last one short.
N, d, D, CHUNK = 600, 5, 24, 256
RTOL = 1e-12


def _operands(task: str) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor, primal.Eigenbasis]:
    """Float64 rows, a random Fourier map and weights; the embedded Gram B, WᵀS²y and the
    eigenbasis that a fit of them takes."""
    gen = np.random.RandomState(7)
    X = gen.randn(N, d)
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.3 * gen.randn(N)
    if task == "classification":
        y = np.where(y > 0, 1.0, -1.0)
    w = gen.rand(N) + 0.25
    M_map, b_map = gen.randn(d, D) * 1.5 / np.sqrt(d), gen.uniform(0, 2 * np.pi, (1, D))
    t = {k: torch.from_numpy(v) for k, v in {"X": X, "M": M_map, "b": b_map, "y": y, "s": w / w.sum()}.items()}
    t["s2"] = t["s"] * t["s"]
    G_W, b_vec = gram.w_basis_from_augmented(gram.gram_plain(t["X"], t["M"], t["b"], t["s2"], t["y"]), D)
    B = primal.embed_from_gram_blocks(G_W, D + 1)
    return t, B, b_vec, primal.eigenbasis(B, b_vec, None, N)


def _column_blocks(a: torch.Tensor, parts: int) -> tuple[torch.Tensor, ...]:
    """``a``'s columns zero-padded to a multiple of ``parts``, in ``parts`` equal blocks."""
    width = -(-a.shape[1] // parts) * parts
    return torch.nn.functional.pad(a, (0, width - a.shape[1])).chunk(parts, dim=1)


def _over_blocks(run: Callable, blocks: Sequence[tuple], calls: int) -> list:
    """``run(block, feature_sum)`` for every block, each call of the hook given the sum over
    the blocks of their partials at that call, as a sum over the ``feature`` group gives it."""
    partials = []
    for block in blocks:
        seen: list[torch.Tensor] = []
        run(block, lambda t, seen=seen: seen.append(t) or t)
        partials.append(seen)
    assert all(len(seen) == calls for seen in partials)
    sums = [torch.stack(call).sum(dim=0) for call in zip(*partials)]
    outs = []
    for block in blocks:
        given = iter(sums)

        def summed(t: torch.Tensor, given=given) -> torch.Tensor:
            total = next(given)
            assert total.shape == t.shape
            return total

        outs.append(run(block, summed))
        assert next(given, None) is None
    return outs


def _assert_close(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> None:
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=RTOL * w.abs().max().item())


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_sweep_plain_completes_num_and_lev_over_column_blocks(task: str, parts: int) -> None:
    t, _, _, basis = _operands(task)
    r_all = 1.0 / (torch.from_numpy(primal.gamma_grid(np.float64))[None, :] + basis.lam[:, None])
    rows = (t["X"], t["M"], t["b"], t["y"], t["s"], t["s2"])
    kw = {"is_classifier": task == "classification", "inv_c0": basis.inv_c0, "chunk_rows": CHUNK}
    whole = sweep.sweep_plain(*rows, basis.Qs, r_all, basis.k, **kw)
    blocks = list(zip(
        _column_blocks(basis.Qs, parts),
        (r.T for r in _column_blocks(r_all.T, parts)),
        (k[0] for k in _column_blocks(basis.k[None, :], parts)),
    ))

    def run(block: tuple, feature_sum: Callable) -> tuple[torch.Tensor, torch.Tensor]:
        return sweep.sweep_plain(*rows, *block, feature_sum=feature_sum, **kw)

    for out in _over_blocks(run, blocks, calls=2 * -(-N // CHUNK)):
        _assert_close(out, whole)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_pass3_plain_completes_num_and_sigma2_over_column_blocks(task: str, parts: int) -> None:
    t, B, b_vec, basis = _operands(task)
    gamma = torch.from_numpy(primal.gamma_grid(np.float64))[400]
    r = 1.0 / (gamma + basis.lam)
    beta_j = basis.sign * primal.resolve_beta(B, None, b_vec, basis, gamma)
    rows = (t["X"], t["M"], t["b"], t["y"])
    kw = {"inv_c0": basis.inv_c0, "chunk_rows": CHUNK}
    whole = pass3.pass3_plain(*rows, basis.Qs, basis.k * r, r, beta_j, **kw)
    blocks = list(zip(
        _column_blocks(basis.Qs, parts),
        (v[0] for v in _column_blocks((basis.k * r)[None, :], parts)),
        (v[0] for v in _column_blocks(r[None, :], parts)),
    ))

    def run(block: tuple, feature_sum: Callable) -> tuple[torch.Tensor, ...]:
        return pass3.pass3_plain(*rows, *block, beta_j, feature_sum=feature_sum, **kw)

    for out in _over_blocks(run, blocks, calls=2 * -(-N // CHUNK)):
        _assert_close(out, whole)
        assert torch.equal(out[2], whole[2])  # the residual takes the whole β: never summed
