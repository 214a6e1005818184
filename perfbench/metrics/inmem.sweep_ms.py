"""Device time of the span ``neo.solve.sweep`` of the in-memory solver (Gu = W·Qs, Gu∘Gu, Gu∘k, then for
the 1024 values of γ in chunks the two contractions, the LOO residuals and their sums), by the
program's CUDA events, mean over the fits."""

from perfbench import spans

PROBES = ()


def read(ctx):
    return spans.mean_ms(spans.records(), "neo.solve.sweep", "device")
