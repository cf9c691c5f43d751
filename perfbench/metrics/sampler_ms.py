"""Device ms per view in the epipolar sampler: CUDA events around the
configuration's ``sampler_entry`` where its ``sampler_caller`` looks it up,
summed over the ray tiles."""


def install(ctx, drv):
    ctx.spans.wrap(ctx.config["sampler_caller"], ctx.config["sampler_entry"], "sampler")


def read(ctx):
    ms = ctx.spans.device_ms("sampler")
    return None if ms is None or not ctx.views else ms / ctx.views
