"""Host time of the span ``neo.fit.validate`` (the device and options resolved, ``check_X_y``,
the weights), mean over the fits: the first part of ``fit.host_prologue_ms``."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.fit.validate", "host")
