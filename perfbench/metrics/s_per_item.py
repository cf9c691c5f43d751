"""Seconds per evaluated item: the window's wall time (host clock, ended by
a synchronise after the last item) over the items it completed, each read,
rendered, copied back and scored."""


def read(ctx):
    return ctx.window_s / ctx.views if ctx.views else None
