"""Device ms per view in the dynamic layer's splatting: the CUDA events of
the program's span ``dynamic.splat`` (the brightness metric and both
``softsplat`` calls of ``renderers/dynamic.py``), over the window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    return program_spans.device_ms_per_view(ctx, "dynamic.splat")
