"""Seconds per view: the window's wall time (host clock, ended by a
synchronise after the last view) over the views or items it completed."""


def read(ctx):
    return ctx.window_s / ctx.views if ctx.views else None
