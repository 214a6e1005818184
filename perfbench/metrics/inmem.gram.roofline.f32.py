"""The in-memory Gram's share of its roofline in float32: the work that K1's share counts
(`yardstick.k1_work`: the phases and the Gram's upper triangle, whatever computes them), from the
in-memory solver's shapes, at the TF32 peak, over the device time of the span ``neo.solve.gram``,
mean over the fits."""

from perfbench import yardstick
from perfbench.readers_inmemory import PROBE, span_roofline

PROBES = (PROBE,)


def read(ctx):
    return span_roofline(ctx, "neo.solve.gram", lambda c, size: yardstick.k1_work(c["n"], c["d"], c["D"], size))
