"""The in-memory fit's share of the card's peak in %: the model operations of one fit
(`yardstick.fit_flops`, from the in-memory solver's shapes) over the traced time per fit times
the dense peak of the rows' dtype."""

from perfbench.readers_inmemory import PROBE, mfu

PROBES = (PROBE,)


def read(ctx):
    return mfu(ctx)
