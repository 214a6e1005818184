"""Device time of ``device_pre_transform`` as the estimator calls it, by CUDA events around
the call, mean over the fits."""

from perfbench.readers import mean_ms, per_step

PROBES = ("pretransform",)


def read(ctx):
    return mean_ms(per_step(ctx, "pretransform")) if ctx.on_cuda else None
