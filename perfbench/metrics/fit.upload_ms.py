"""Device time of ``upload_rows`` (the rows from pageable host memory to the card), by CUDA
events around the call, mean over the fits."""

from perfbench.readers import mean_ms, per_step

PROBES = ("upload",)


def read(ctx):
    return mean_ms(per_step(ctx, "upload")) if ctx.on_cuda else None
