"""Faults planted in the timed path of a fit, to see the comparison fail.

Each fault wraps one of the program's functions where its caller looks it up (the kernel
entries in ``neo_ls_svm_torch.models.primal``, the edge draw in
``neo_ls_svm_torch.ops.pretransform_device``), and names the number that has to catch it. The CPU
tests plant each in a whole run (``tests/test_perfbench_faults.py``); ``calibrate.py``
reads them at a cell's full size on the card, for the limits' upper readings.
"""

import contextlib
import importlib
from collections.abc import Callable, Iterator

import torch


def _half_the_rows(fn: Callable, s2_at: int | None, s_at: int | None) -> Callable:
    """The kernel over the first half of the rows, its mean taken over them alone: the
    weights s doubled and s² quadrupled."""

    def broken(X, *args, **kwargs):
        half = X.shape[0] // 2
        args = [a[:half] if torch.is_tensor(a) and a.shape[:1] == X.shape[:1] else a for a in args]
        if s_at is not None:
            args[s_at] = args[s_at] * 2
        args[s2_at] = args[s2_at] * 4
        return fn(X[:half], *args, **kwargs)

    return broken


def _draw_from_half_the_rows(fn: Callable) -> Callable:
    """The separator's edge samples drawn from the first half of the rows alone."""

    def broken(u, cum_mass):
        return fn(u, cum_mass[: cum_mass.shape[0] // 2])

    return broken


def _objective_altered(fn: Callable) -> Callable:
    """K2's answer altered where it is made: the objective's last value made the least."""

    def broken(*args, **kwargs):
        err, objective = fn(*args, **kwargs)
        objective = objective.clone()
        objective[-1] = objective.min() * 0.5
        return err, objective

    return broken


def _gram_altered(fn: Callable) -> Callable:
    """K1's answer altered where it is made: one entry of the Gram off by a part in 10³."""

    def broken(*args, **kwargs):
        G = fn(*args, **kwargs).clone()
        G[1, 1] *= 1 + 1e-3
        return G

    return broken


PRIMAL, PRETRANSFORM = "neo_ls_svm_torch.models.primal", "neo_ls_svm_torch.ops.pretransform_device"
# name: (where the caller looks it up, the breaker, the number that has to catch it). The
# arguments after X: K1(X, M, b, s2, y), K2(X, M, b, y, s, s2, Qs, r_all, k).
FAULTS = {
    "k1_half_the_rows": (f"{PRIMAL}:fused_augmented_gram", lambda fn: _half_the_rows(fn, 2, None), "gram_err"),
    "k2_half_the_rows": (f"{PRIMAL}:fused_loo_sweep", lambda fn: _half_the_rows(fn, 4, 3), "sweep_err"),
    "k1_answer_altered": (f"{PRIMAL}:fused_augmented_gram", _gram_altered, "gram_err"),
    "k2_answer_altered": (f"{PRIMAL}:fused_loo_sweep", _objective_altered, "sweep_err"),
    "edges_from_half_the_rows": (f"{PRETRANSFORM}:_sample_rows", _draw_from_half_the_rows, "sep_err"),
}


@contextlib.contextmanager
def planted(name: str) -> Iterator[str]:
    """The fault ``name`` in place for the block; yields the number that has to catch it."""
    target, breaker, number = FAULTS[name]
    module_name, attr = target.split(":")
    owner = importlib.import_module(module_name)
    original = getattr(owner, attr)
    setattr(owner, attr, breaker(original))
    try:
        yield number
    finally:
        setattr(owner, attr, original)
