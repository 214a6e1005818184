"""The share of the traced fit window in which no operation ran on the device (torch.profiler)."""

from perfbench.readers import idle_share

PROBES = ()


def read(ctx):
    return idle_share(ctx)
