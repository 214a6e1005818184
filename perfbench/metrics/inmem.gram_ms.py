"""Device time of the span ``neo.solve.gram`` of the in-memory solver (W = [cos U/√D, 1 |
sin U/√D, 0] from U = X·M + b, WᵀS²W and its real embedding), by the program's CUDA events,
mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.solve.gram", "device")
