"""Set-up seconds: from the start of ``perfbench/run.py`` to the window's
first view (imports, the kernel library, weights, the scene, warm-up)."""


def read(ctx):
    return ctx.setup_s
