"""The program's own spans and counters (``pgdvs_tpu_torch.utils.tracing``)
in a traced run.

``install(ctx, drv)``, shared by the readers that read them and run once
per loop object ``drv`` (``drivers/``): turns the registry on, resets it at
the window's start and keeps its summary at the window's end
(``ctx.program_spans``), so the profiled views after the window add nothing
while the spans still name the host's time in their trace; ``drv.release``
turns the registry off again. Where the program has no such registry,
nothing is installed and every reader reads nothing.
"""

from __future__ import annotations

import importlib


def registry():
    """The program's tracing module, or None where it has no registry."""
    try:
        mod = importlib.import_module("pgdvs_tpu_torch.utils.tracing")
    except ImportError:
        return None
    return mod if all(hasattr(mod, f) for f in ("enable", "reset", "summary")) else None


def install(ctx, drv):
    if getattr(drv, "_program_spans", False):
        return
    drv._program_spans = True
    tracing = registry()
    if tracing is None:
        return
    tracing.enable()
    window, release = drv.window, drv.release

    def traced_window(seconds, on_start):
        def start():
            on_start()
            tracing.reset()

        out = window(seconds, start)
        ctx.sync()
        ctx.program_spans = tracing.summary()
        return out

    def traced_release():
        tracing.disable()
        tracing.reset()
        return release()

    drv.window, drv.release = traced_window, traced_release


def summary(ctx):
    """The window's summary, or None."""
    return getattr(ctx, "program_spans", None)


def span(ctx, name):
    """The totals of span ``name`` over the window, or None."""
    s = summary(ctx)
    return None if s is None else s["spans"].get(name)


def views(ctx):
    """Root spans ``view`` the window completed (0 without them)."""
    v = span(ctx, "view")
    return v["count"] if v else 0


def under_view(ctx, name):
    """The totals of span ``name`` opened under a ``view``, or None."""
    s = summary(ctx)
    if s is None or "view" not in s["roots"]:
        return None
    return s["roots"]["view"]["within"].get(name)


def device_ms_per_view(ctx, name):
    t = span(ctx, name)
    n = views(ctx)
    if not t or t["device_ms"] is None or not n:
        return None
    return t["device_ms"] / n
