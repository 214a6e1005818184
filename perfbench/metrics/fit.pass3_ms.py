"""Device time of the span ``neo.solve.pass3`` (the per-row LOO statistics and residuals at the
chosen γ), by the program's CUDA events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.solve.pass3", "device")
