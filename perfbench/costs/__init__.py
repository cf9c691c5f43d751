"""The yardstick: operations and bytes of each kernel from its shapes, and
the card's peaks. One module per kernel, named by the configurations'
``gnt_kernel_cost``."""

import importlib

# NVIDIA H100 SXM data sheet: dense bf16 tensor cores and HBM3 bandwidth,
# at the card's full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops, nbytes):
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the memory peak, in ms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def kernel_cost(name):
    """The ``cost(v, r, s, c)`` function of ``perfbench/costs/<name>.py``."""
    return importlib.import_module(f"perfbench.costs.{name}").cost


def view_tiles(config):
    """[{"flops", "bytes", "bound_ms"}] of the GNT kernel's launches over one
    view of the configuration: one per ray tile (the last one short)."""
    cost = kernel_cost(config["gnt_kernel_cost"])
    h, w = config["hw"]
    tiles = []
    for r0 in range(0, h * w, config["ray_tile"]):
        r = min(config["ray_tile"], h * w - r0)
        flops, nbytes = cost(config["n_spatial"], r, config["n_coarse_samples"],
                             config["gnt_in_channels"])
        tiles.append({"flops": flops, "bytes": nbytes, "bound_ms": bound_ms(flops, nbytes)})
    return tiles
