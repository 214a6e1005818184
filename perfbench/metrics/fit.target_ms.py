"""Host time of the span ``neo.fit.target`` (``np.unique`` of the labels, the task, the ±1 or
cast target), mean over the fits: the second part of ``fit.host_prologue_ms``."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.fit.target", "host")
