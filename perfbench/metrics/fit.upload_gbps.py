"""The rows' upload rate in GB/s: the bytes the spans ``neo.upload`` count over their device
time by the program's CUDA events, summed over the window."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.gbps(spans.records(), "neo.upload")
