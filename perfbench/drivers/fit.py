"""Traffic of kind ``fit``: a closed loop of whole fits on the configuration's rows.

Set-up makes the rows on the device from the seed, hands them to the host as NumPy in the
configuration's dtype, and runs one warm fit on them (the kernels' build on a checkout's
first run, cuBLAS and cuSOLVER handles, the host's pages). The window then fits a new
``NeoLSSVM(**traffic["estimator"])`` on the same NumPy rows, back to back; the fit that is
running when the window's time is up is finished and counted. ``fit_s`` is the window's
length over the fits in it. Once the window has closed, the fits are held to the
reference (``fitcheck``): every fit's K2 answer and β, and the last fit's
pre-transform, Gram, sweep operands and per-row statistics.
"""

import sys
import time
import traceback

import numpy as np

from perfbench import fitcheck, harness, trace

# K1's Gram, K2's answer and K2's operands, kept from the fits for the comparison.
PROBES = ("k1", "k2")


def make_rows(ctx: harness.Context, parts: tuple[str, ...]) -> dict[str, np.ndarray]:
    """The configuration's rows from the seed, as NumPy in its dtype."""
    dataset = harness.load_module(harness.BENCH / "datasets" / f"{ctx.cell.config['generator']}.py")
    made = dataset.make(ctx.cell.config, ctx.seed, ctx.device, parts)
    rows = {k: v.cpu().numpy().astype(ctx.cell.config["dtype"], copy=False) for k, v in made.items()}
    del made
    if ctx.on_cuda:
        import torch  # noqa: PLC0415

        torch.cuda.empty_cache()
    return rows


def launches_by_path() -> dict[str, int]:
    from neo_ls_svm_torch.ops.cuda import gram, sweep  # noqa: PLC0415

    return {f"k1.{p}": v for p, v in gram.path_launches.items()} | {f"k2.{p}": v for p, v in sweep.path_launches.items()}


def run(ctx: harness.Context) -> None:
    import torch  # noqa: PLC0415

    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415

    rows = make_rows(ctx, ("train",))
    X, y = rows["X"], rows["y"]
    params = dict(ctx.cell.traffic.get("estimator", {}))

    def fit() -> NeoLSSVM:
        return NeoLSSVM(device=ctx.device, **params).fit(X, y)

    fit()  # warm: every shape of the window, built and loaded
    ctx.sync()
    before = launches_by_path()
    prof = trace.profiler() if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    steps, model, ends = [], None, []
    t0 = time.perf_counter()
    ctx.setup_s = harness.process_age_s()
    while True:
        ctx.step = ctx.attempted
        ctx.attempted += 1
        try:
            model = fit()
            steps.append(fitcheck.step_outputs(model, ctx.kept["k2"]))
        except (RuntimeError, ValueError):
            ctx.failed += 1
            traceback.print_exc(file=sys.stderr)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        ctx.profile = trace.summarize(prof, ctx.window_s)
        del prof
    ctx.step = -1
    ctx.e2e = {"fit_s": ctx.window_s / max(len(steps), 1), "setup_s": ctx.setup_s}
    if ctx.on_cuda:
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    each = np.diff([0.0, *ends])
    print(f"fits {len(ends)}: min {each.min():.4f} s, median {np.median(each):.4f} s, max {each.max():.4f} s", file=sys.stderr)
    print(f"each fit's seconds: {[round(float(t), 4) for t in each]}", file=sys.stderr)
    after = launches_by_path()
    print(f"launches in the window by path: { {k: after[k] - before[k] for k in after} }", file=sys.stderr)
    if model is None:
        return
    # The window's answers, then the program's state freed before the reference runs.
    gram = ctx.kept.pop("k1").double().cpu().numpy()
    operands = fitcheck.sweep_operands(ctx.kept.pop("k2.args"))
    candidate = fitcheck.program_outputs(model, gram, operands, [fitcheck.pulled(step) for step in steps])
    setting = fitcheck.setting(model)
    is_classifier = model._estimator_type == "classifier"
    ctx.kept.clear()
    del model, steps
    if ctx.on_cuda:
        torch.cuda.empty_cache()
    ref = fitcheck.Reference(X, y, is_classifier, setting, candidate["M"], candidate["b"], device=ctx.device)
    ctx.numbers = fitcheck.numbers(candidate, ref)
