"""K2's share of its roofline in float64 (`yardstick.k2_work`): the bound of its work counted from
the solver's shapes over its device time by CUDA events, summed over its calls in the window."""

from perfbench import yardstick
from perfbench.readers import kernel_roofline

PROBES = ("solver", "k2")


def read(ctx):
    return kernel_roofline(ctx, "k2", "float64", lambda c, size: yardstick.k2_work(c["n"], c["d"], c["D"], c["G"], size))
