"""Device ms per view in the static cloud's K-NN outlier removal: the CUDA
events of the program's span ``static.geo.knn`` (around
``statistical_outlier_mask`` in ``renderers/static_geo.py``), over the
window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    return program_spans.device_ms_per_view(ctx, "static.geo.knn")
