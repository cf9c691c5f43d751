"""Host-device synchronisations per view: the program's ``sync`` spans
(each a point where the host waits on the card) under its root span
``view``, over the window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    n = program_spans.views(ctx)
    if not n:
        return None
    sync = program_spans.under_view(ctx, "sync")
    return (sync["count"] if sync else 0) / n
