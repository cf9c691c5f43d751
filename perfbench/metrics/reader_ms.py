"""Host ms per item in the reader: the host clock around each item's
assembly (``NvidiaEvalDataset.__getitem__``: decodes, resizes, npz reads,
the depth range), in the loader's threads."""


def install(ctx, drv):
    ctx.spans.wrap(drv.items, "__getitem__", "reader", on_device=False)


def read(ctx):
    ms = ctx.spans.host_ms("reader")
    return None if ms is None else ms / ctx.spans.count("reader")
