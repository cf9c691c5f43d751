"""Share of items the prefetching loader had ready when the evaluation loop
asked for them, %: the program's counters ``loader.ready`` over
``loader.items`` (``data/loader.py:PrefetchLoader``)."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    s = program_spans.summary(ctx)
    items = s["counters"].get("loader.items", 0) if s else 0
    if not items:
        return None
    return 100.0 * s["counters"].get("loader.ready", 0) / items
