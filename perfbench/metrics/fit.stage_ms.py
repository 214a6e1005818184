"""Host time of the span ``neo.fit.stage`` (the feature map and fit plan, the γ grid, y, the
weights and γ sent, the rows padded to a chunk multiple), mean over the fits: the third part of
``fit.host_prologue_ms``."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.fit.stage", "host")
