"""Device ms per view in the feature network: CUDA events around every
forward of the program's ResUNet module (forward hooks)."""


def install(ctx, drv):
    ctx.spans.hook(drv.models[0], "resunet")


def read(ctx):
    ms = ctx.spans.device_ms("resunet")
    return None if ms is None or not ctx.views else ms / ctx.views
