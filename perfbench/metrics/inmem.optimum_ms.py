"""Device time of the span ``neo.solve.optimum`` of the in-memory solver (the chosen γ, its per-row LOO
statistics, the Cholesky re-solve of β and the training residuals), by the program's CUDA
events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.solve.optimum", "device")
