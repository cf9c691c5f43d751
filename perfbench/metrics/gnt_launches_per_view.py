"""Launches per view of the configuration's GNT kernel entry, from the
kernel wrapper's own launch count over the traced window."""


def read(ctx):
    return ctx.launches / ctx.views if ctx.views else None
