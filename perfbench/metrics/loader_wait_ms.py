"""Host ms per item that the evaluation loop waits for its next item: each
``next()`` of ``data.loader.to_device_prefetch`` as ``Evaluator.run`` calls
it (the prefetching loader, then the item's host-to-device staging)."""


def install(ctx, drv):
    ctx.spans.wrap_generator("pgdvs_tpu_torch.engines.evaluator", "to_device_prefetch",
                             "loader_wait")


def read(ctx):
    ms = ctx.spans.host_ms("loader_wait")
    return None if ms is None else ms / ctx.spans.count("loader_wait")
