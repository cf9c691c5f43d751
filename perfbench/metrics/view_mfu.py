"""Model FLOPs utilisation of a view, %: the GNT's dense products for every
ray tile of the view (``perfbench/costs/<gnt_kernel_cost>``) plus the
ResUNet's convolutions (``perfbench/costs/resunet``), over the traced
window's seconds per view and the bf16 peak."""

from perfbench.costs import PEAK_BF16_FLOPS, resunet, view_tiles


def view_flops(config):
    h, w = config["hw"]
    return (sum(t["flops"] for t in view_tiles(config))
            + resunet.flops(config["n_spatial"], h, w, config["feat_ch"]))


def read(ctx):
    if not ctx.views or ctx.device.type != "cuda":
        return None
    return 100.0 * view_flops(ctx.config) / (ctx.window_s / ctx.views) / PEAK_BF16_FLOPS
