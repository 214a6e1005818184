"""Faults planted in the in-memory solver's timed path, to see the comparison fail.

``faults.py``'s faults break K1 and K2, which an in-memory fit never calls. These break what
``primal_fit`` calls instead, where it looks it up in ``neo_ls_svm_torch.models.primal``: the
γ-sweep (``_sweep_in_memory``) and the embedded Gram (``_embedding_gram``). One breaks the
normalizer, where ``neo_ls_svm_torch.ops.pretransform_device`` looks it up, as no fault of
``faults.py`` does; the edges drawn from half the rows are ``faults.py``'s own. Each names the number that has to catch it. The CPU
tests plant each in a whole run of ``msd32.fit`` (``perfbench/tests/test_perfbench_inmemory.py``);
``calibrate_inmemory.py`` reads them at the cell's full size on the card.
"""

import contextlib
import importlib
from collections.abc import Callable, Iterator

from perfbench import faults


def _sweep_over_half_the_rows(fn: Callable) -> Callable:
    """The sweep's answer from the first half of the rows alone, its mean taken over them (the
    weights s doubled and s² quadrupled); the per-row products that the optimum reuses stay
    those of every row, so that the fit runs on."""

    def broken(W, Qs, k, lam, y, s, s2, *args, **kwargs):
        whole = fn(W, Qs, k, lam, y, s, s2, *args, **kwargs)
        half = W.shape[0] // 2
        part = fn(W[:half], Qs, k, lam, y[:half], 2 * s[:half], 4 * s2[:half], *args, **kwargs)
        return whole._replace(loo_errors=part.loo_errors, objective=part.objective)

    return broken


def _normalizer_from_half_the_rows(fn: Callable) -> Callable:
    """The normalizer's medians and mean deviations from the first half of the rows alone, the
    weights of the rest zeroed; the bins' totals, which weigh each pair of bins, stay whole."""

    def broken(X, w, codes, bin_totals, **kwargs):
        w = w.clone()
        w[w.shape[0] // 2 :] = 0
        return fn(X, w, codes, bin_totals, **kwargs)

    return broken


PRIMAL = faults.PRIMAL
# name: (where the caller looks it up, the breaker, the number that has to catch it).
FAULTS = {
    "sweep_half_the_rows": (f"{PRIMAL}:_sweep_in_memory", _sweep_over_half_the_rows, "sweep_err"),
    "gram_altered": (f"{PRIMAL}:_embedding_gram", faults._gram_altered, "gram_err"),
    "normalizer_half_the_rows": (
        f"{faults.PRETRANSFORM}:_normalizer_stats_device", _normalizer_from_half_the_rows, "scale_err"
    ),
    "edges_from_half_the_rows": faults.FAULTS["edges_from_half_the_rows"],
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
