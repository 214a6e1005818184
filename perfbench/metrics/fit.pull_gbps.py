"""The results' pull rate in GB/s: the bytes the spans ``neo.fit.pull`` count over their
device time by the program's CUDA events, summed over the window."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.gbps(spans.records(), "neo.fit.pull")
