"""The whole fit's share of the card's peak in %: the model operations of one fit
(`yardstick.fit_flops`, from the solver's shapes) over the traced time per fit times the dense
peak of the rows' dtype."""

from perfbench import yardstick
from perfbench.readers import DTYPES, card, solver_call

PROBES = ("solver",)


def read(ctx):
    peaks = card(ctx)
    calls = [r for r in ctx.records if r["probe"] == "solver"]
    if peaks is None or not calls or ctx.window_s <= 0:
        return None
    call, dtype = solver_call(calls[-1]), DTYPES.get(calls[-1].get("dtype"))
    if call is None or dtype is None:
        return None
    per_fit_s = ctx.window_s / len(calls)
    ops = yardstick.fit_flops(call["n"], call["d"], call["D"], call["G"])
    return 100.0 * ops / (per_fit_s * peaks["tflops"][dtype] * 1e12)
