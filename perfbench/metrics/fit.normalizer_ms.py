"""Device time of the span ``neo.pretransform.normalizer`` (the target bins and the normalizer's
bisection over the rows), by the program's CUDA events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.pretransform.normalizer", "device")
