"""Device ms per view in the pure-geometry static layer (its K-NN outlier
removal and point raster): the CUDA events of the program's span
``static.geo`` (``renderers/static_geo.py:render_static_geo``), over the
window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    return program_spans.device_ms_per_view(ctx, "static.geo")
