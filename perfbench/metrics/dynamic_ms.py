"""Device ms per view in the dynamic layer (the lift, the KNN outlier mask,
softsplat): CUDA events around ``renderers.compose.render_dynamic``."""


def install(ctx, drv):
    ctx.spans.wrap("pgdvs_tpu_torch.renderers.compose", "render_dynamic", "dynamic")


def read(ctx):
    ms = ctx.spans.device_ms("dynamic")
    return None if ms is None or not ctx.views else ms / ctx.views
