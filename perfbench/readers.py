"""What the per-layer metrics' readers share: per-step times from the probes' records, the
shapes of the solver's call, and the card's peaks. A reader returns None where its run has
nothing for it to read, and the metric is then left out of the result."""

import statistics
from typing import Any

from perfbench import yardstick
from perfbench.probes_runtime import by_step

DTYPES = {"torch.float32": "float32", "torch.float64": "float64"}


def per_step(ctx: Any, probe: str, field: str = "ms") -> dict[int, float]:
    """The probe's summed time in each step of the window that called it."""
    return {step: sum(r[field] for r in recs) for step, recs in by_step(ctx.records, probe).items()}


def mean_ms(values: dict[int, float]) -> float | None:
    return statistics.fmean(values.values()) if values else None


def solver_call(record: dict) -> dict[str, int] | None:
    """n (true rows), d, D and G of a ``primal_fit_streaming(X, M, b, y, s, γs, …)`` call."""
    shapes = record["shapes"]
    if len(shapes) < 6 or shapes[0] is None or shapes[1] is None or shapes[5] is None:
        return None
    return {"n": int(record["kw"].get("num_samples", shapes[0][0])), "d": shapes[0][1], "D": shapes[1][1], "G": shapes[5][0]}


def card(ctx: Any) -> dict | None:
    if not ctx.on_cuda:
        return None
    import torch  # noqa: PLC0415

    return yardstick.peaks(torch.cuda.get_device_name(ctx.device))


def kernel_roofline(ctx: Any, probe: str, dtype: str, work: Any) -> float | None:
    """A kernel's share of its roofline in %: the summed bound of its calls in ``dtype``
    over their summed device time. ``work(call, itemsize)`` gives (ops, bytes) from the
    solver's shapes in the same step."""
    peaks = card(ctx)
    solvers = {r["step"]: solver_call(r) for r in ctx.records if r["probe"] == "solver"}
    bound = spent = 0.0
    for r in ctx.records:
        if r["probe"] != probe or DTYPES.get(r.get("dtype")) != dtype:
            continue
        call = solvers.get(r["step"])
        if peaks is None or call is None:
            return None
        itemsize = 4 if dtype == "float32" else 8
        ops, nbytes = work(call, itemsize)
        bound += yardstick.bound_ms(ops, nbytes, dtype, peaks)
        spent += r["ms"]
    return 100.0 * bound / spent if spent > 0 else None


def idle_share(ctx: Any) -> float | None:
    """The share of the traced window in % in which no operation ran on the device."""
    if ctx.profile is None or ctx.profile["window_s"] <= 0 or not ctx.on_cuda:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / ctx.profile["window_s"])
