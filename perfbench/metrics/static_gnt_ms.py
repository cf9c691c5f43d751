"""Device ms per view in the static GNT layer: CUDA events around
``renderers.compose.render_image_gnt``, as ``render_novel_view`` calls it."""


def install(ctx, drv):
    ctx.spans.wrap("pgdvs_tpu_torch.renderers.compose", "render_image_gnt", "static_gnt")


def read(ctx):
    ms = ctx.spans.device_ms("static_gnt")
    return None if ms is None or not ctx.views else ms / ctx.views
