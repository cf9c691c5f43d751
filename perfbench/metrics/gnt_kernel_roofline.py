"""The GNT kernel's share of its roofline, %: the least time the card
could take for the launches (``perfbench/costs/<gnt_kernel_cost>`` at the
configuration's tiles, samples, sources and channels), over the summed
device time of the kernel entry's calls (CUDA events around the
configuration's ``gnt_kernel_entry`` where its ``gnt_kernel_caller`` looks it
up)."""

from perfbench.costs import view_tiles


def install(ctx, drv):
    ctx.spans.wrap(ctx.config["gnt_kernel_caller"], ctx.config["gnt_kernel_entry"],
                   "gnt_kernel")


def read(ctx):
    ms = ctx.spans.device_ms("gnt_kernel")
    if not ms or not ctx.launches:
        return None
    tiles = view_tiles(ctx.config)
    view_bound_ms = sum(t["bound_ms"] for t in tiles)
    return 100.0 * (ctx.launches / len(tiles)) * view_bound_ms / ms
