"""Host ms per view spent issuing it: the host clock of the program's root
span ``view`` (``renderers/compose.py:render_novel_view``) less its ``sync``
spans, where the host waits on the card, over the window's views."""

from perfbench.harness import program_spans


def install(ctx, drv):
    program_spans.install(ctx, drv)


def read(ctx):
    view = program_spans.span(ctx, "view")
    if not view or not view["count"]:
        return None
    sync = program_spans.under_view(ctx, "sync")
    return (view["host_ms"] - (sync["host_ms"] if sync else 0.0)) / view["count"]
