"""The in-memory γ-sweep's share of its roofline in float32: the work that K2's share counts
(`yardstick.k2_work`: Gu and the two contractions over the grid, whatever computes them), from
the in-memory solver's shapes, at the TF32 peak, over the device time of the span
``neo.solve.sweep``, mean over the fits."""

from perfbench import yardstick
from perfbench.readers_inmemory import PROBE, span_roofline

PROBES = (PROBE,)


def read(ctx):
    return span_roofline(ctx, "neo.solve.sweep", lambda c, size: yardstick.k2_work(c["n"], c["d"], c["D"], c["G"], size))
