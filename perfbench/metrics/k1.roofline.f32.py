"""K1's share of its roofline in float32 (`yardstick.k1_work`): the bound of its work counted from
the solver's shapes over its device time by CUDA events, summed over its calls in the window."""

from perfbench import yardstick
from perfbench.readers import kernel_roofline

PROBES = ("solver", "k1")


def read(ctx):
    return kernel_roofline(ctx, "k1", "float32", lambda c, size: yardstick.k1_work(c["n"], c["d"], c["D"], size))
