"""Device time of the span ``neo.solve.eigh`` (the eigendecomposition of the 2M × 2M Gram and
k = Qsᵀb), by the program's CUDA events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.solve.eigh", "device")
