"""Device time of the span ``neo.fit.pull`` (every result tensor of the fit to the host), by the
program's CUDA events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.fit.pull", "device")
