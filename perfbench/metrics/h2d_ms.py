"""Device ms per item of the loader's host-to-device copies: the CUDA
events on the copy stream of the program's span ``loader.stage``
(``data/loader.py:to_device_prefetch``), over the items it staged."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    t = program_spans.span(ctx, "loader.stage")
    if not t or t["device_ms"] is None or not t["count"]:
        return None
    return t["device_ms"] / t["count"]
