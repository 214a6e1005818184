"""What the readers of the in-memory solver's metrics share: its shapes from the probe
``solver_inmemory`` (``primal_fit`` as the estimator calls it, its arguments in
``primal_fit_streaming``'s order), a step's share of its roofline from the program's own span,
and the whole fit's share of the card's peak. A reader returns None where its run has nothing
to read (no in-memory fit, no span, no card), and the metric is left out of the result."""

from collections.abc import Callable
from typing import Any

from perfbench import spans, yardstick
from perfbench.readers import DTYPES, card, solver_call

PROBE = "solver_inmemory"


def _calls(ctx: Any) -> list[dict]:
    return [r for r in ctx.records if r["probe"] == PROBE]


def span_roofline(ctx: Any, span: str, work: Callable[[dict, int], tuple[float, float]]) -> float | None:
    """The share in % of float32's roofline of the work ``work(call, itemsize)`` gives from
    the solver's shapes, over the mean device time per fit of the span called ``span``."""
    peaks = card(ctx)
    calls = [r for r in _calls(ctx) if DTYPES.get(r.get("dtype")) == "float32"]
    ms = spans.mean_ms(spans.records(), span, "device")
    if peaks is None or not calls or not ms:
        return None
    call = solver_call(calls[-1])
    if call is None:
        return None
    ops, nbytes = work(call, 4)
    return 100.0 * yardstick.bound_ms(ops, nbytes, "float32", peaks) / ms


def mfu(ctx: Any) -> float | None:
    """``yardstick.fit_flops`` of the in-memory fits over (the traced window's time per such
    fit × the dense peak of the rows' dtype), in %."""
    peaks = card(ctx)
    calls = _calls(ctx)
    if peaks is None or not calls or ctx.window_s <= 0:
        return None
    call, dtype = solver_call(calls[-1]), DTYPES.get(calls[-1].get("dtype"))
    if call is None or dtype is None:
        return None
    per_fit_s = ctx.window_s / len(calls)
    ops = yardstick.fit_flops(call["n"], call["d"], call["D"], call["G"])
    return 100.0 * ops / (per_fit_s * peaks["tflops"][dtype] * 1e12)
