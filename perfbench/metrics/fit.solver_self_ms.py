"""Device time of ``primal_fit_streaming`` less its K1 and K2 calls (the eigendecomposition, the
re-solve, pass 3), by CUDA events around each call, mean over the fits."""

from perfbench.readers import mean_ms, per_step

PROBES = ("solver", "k1", "k2")


def read(ctx):
    if not ctx.on_cuda:
        return None
    solver, k1, k2 = (per_step(ctx, p) for p in PROBES)
    return mean_ms({s: t - k1.get(s, 0.0) - k2.get(s, 0.0) for s, t in solver.items()})
