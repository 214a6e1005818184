"""Traffic of kind ``fit_inmemory``: ``fit``'s closed loop of whole fits (``drivers/fit.py``) on
a deployment whose fits take the in-memory solver, ``primal_fit``.

Set-up and the window are ``fit``'s: the rows made on the device from the seed and handed to
the host as NumPy in the configuration's dtype, one warm fit, then a new
``NeoLSSVM(**traffic["estimator"])`` on the same rows, back to back, for the window's
seconds. Each fit's route shows in what it kept: an in-memory fit the answer of its γ-sweep
(probe ``sweep_inmemory`` on ``_sweep_in_memory``), a streaming fit K2's. The window's fits
are printed by route, beside K1's and K2's launches by path.

Once the window has closed, the fits are held to ``fitcheck``'s float64 reference whichever
route they took: every fit's sweep answer and β, and the last fit's pre-transform, Gram,
sweep operands and per-row statistics. The Gram is compared as the real embedding B that the
solver eigendecomposes (:func:`numbers`): an in-memory fit forms B itself (probe
``gram_inmemory`` on ``_embedding_gram``) and no augmented Gram, and a streaming fit's K1
Gram is embedded as the streaming solver embeds it. The sweep's operands are Qs, k and
r_all = 1/(γ + λ), formed from the kept λ as the in-memory sweep forms its chunks' columns.
"""

import sys
import time
import traceback
from typing import Any

import numpy as np
import torch

from perfbench import fitcheck, harness, trace
from perfbench.drivers.fit import launches_by_path, make_rows
from perfbench.reference import lssvm

# The in-memory solver's call (its shapes), its embedded Gram and its sweep's answer and
# operands; K1's Gram and K2's answer and operands where a fit streams.
PROBES = ("solver_inmemory", "gram_inmemory", "sweep_inmemory", "k1", "k2")


def taken_answer(kept: dict) -> tuple[str, Any]:
    """The route of the fit that has just returned and its sweep's answer, taken out of the
    keeps: the in-memory answer also holds the sweep's n × 2M products, which must not
    outlive the fit."""
    if "sweep_inmemory" in kept:
        return "inmemory", kept.pop("sweep_inmemory")
    return "streaming", kept.pop("k2")


def embedded(gram: torch.Tensor) -> np.ndarray:
    """The real embedding B of an augmented Gram, formed in the Gram's own dtype as the
    streaming solver forms it (``reference/lssvm.py``'s ``_w_basis`` and ``_embedding``)."""
    G = gram.cpu()
    G_W, _ = lssvm._w_basis(G, (G.shape[0] - 2) // 2)
    return lssvm._embedding(G_W).double().numpy()


def inmemory_operands(args: dict) -> dict[str, np.ndarray]:
    """The in-memory sweep's operands as the probe kept them, as NumPy float64 (exact from
    float32): Qs, k, and r_all = 1/(γ + λ) in the program's dtype, on its device, as each
    chunk of the sweep forms its columns."""
    r_all = 1.0 / (args["gammas"][None, :] + args["lam"][:, None])
    return {"r_all": r_all.double().cpu().numpy(), **{name: args[name].double().cpu().numpy() for name in ("Qs", "k")}}


def last_fit_operands(route: str, kept: dict) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """The embedded Gram and the sweep's operands of the last fit, taken out of the keeps."""
    if route == "inmemory":
        return kept.pop("gram_inmemory").double().cpu().numpy(), inmemory_operands(kept.pop("sweep_inmemory.args"))
    return embedded(kept.pop("k1")), fitcheck.sweep_operands(kept.pop("k2.args"))


def numbers(candidate: dict, ref: fitcheck.Reference) -> dict[str, float]:
    """``fitcheck.numbers`` with ``gram_err`` read on the embedded Gram: the candidate's
    ``gram`` is B, held to the reference's own embedding B_r by max |ΔB_ij|/√(B_r,ii·B_r,jj).
    ``fitcheck.numbers`` is handed the reference's own augmented Gram in the candidate's
    place, so its augmented ``gram_err`` reads 0 and is replaced."""
    B_r = ref.fit.B.double().cpu().numpy()
    diag = np.sqrt(np.abs(np.diag(B_r)))
    G_r = ref.fit.gram.double().cpu().numpy()
    return {
        **fitcheck.numbers({**candidate, "gram": G_r}, ref),
        "gram_err": float(np.max(np.abs(candidate["gram"] - B_r) / np.outer(diag, diag))),
    }


def run(ctx: harness.Context) -> None:
    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415

    rows = make_rows(ctx, ("train",))
    X, y = rows["X"], rows["y"]
    params = dict(ctx.cell.traffic.get("estimator", {}))

    def fit() -> NeoLSSVM:
        return NeoLSSVM(device=ctx.device, **params).fit(X, y)

    fit()  # warm: every shape of the window, built and loaded
    ctx.kept.clear()  # the warm fit's products, freed before the window
    ctx.sync()
    before = launches_by_path()
    prof = trace.profiler() if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    steps, routes, model, ends = [], [], None, []
    t0 = time.perf_counter()
    ctx.setup_s = harness.process_age_s()
    while True:
        ctx.step = ctx.attempted
        ctx.attempted += 1
        try:
            model = fit()
            route, swept = taken_answer(ctx.kept)
            routes.append(route)
            steps.append(fitcheck.step_outputs(model, swept))
            del swept
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
    print(f"fits in the window by route: { {r: routes.count(r) for r in sorted(set(routes))} }", file=sys.stderr)
    after = launches_by_path()
    print(f"launches in the window by path: { {k: after[k] - before[k] for k in after} }", file=sys.stderr)
    if model is None:
        return
    # The window's answers, then the program's state freed before the reference runs.
    gram, operands = last_fit_operands(routes[-1], ctx.kept)
    candidate = fitcheck.program_outputs(model, gram, operands, [fitcheck.pulled(step) for step in steps])
    setting = fitcheck.setting(model)
    is_classifier = model._estimator_type == "classifier"
    ctx.kept.clear()
    del model, steps
    if ctx.on_cuda:
        torch.cuda.empty_cache()
    ref = fitcheck.Reference(X, y, is_classifier, setting, candidate["M"], candidate["b"], device=ctx.device)
    ctx.numbers = numbers(candidate, ref)
