"""Device ms per view in the dynamic layer's K-NN outlier removal: the CUDA
events of the program's span ``dynamic.knn``
(``kernels/knn.py:statistical_outlier_mask``), over the window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    return program_spans.device_ms_per_view(ctx, "dynamic.knn")
