"""Operations and bytes of K2 in its unfolded mode, one 2048-ray tile.

``gnt_fused_apply_mono3`` on the exact sampler's outputs, every operand
read: frozen from ``chip_smoke.mono3_cost(v, r, s, c, "unfolded")``. The
products are K2's masked ones (``k2_masked``).
"""

from perfbench.costs import k2_masked


def cost(v, r, s, c):
    """(FLOP, bytes) of one K2 unfolded forward: bf16 features [V, N, C],
    the uint8 mask [V, N], the bf16 ray-diff code [V, N, 4] and the bf16
    point + view code [N, 126] read once; f32 rgb, weights and count
    written once."""
    flops, _ = k2_masked.cost(v, r, s, c)
    n = r * s
    nbytes = v * n * c * 2 + v * n + v * n * 4 * 2 + n * 126 * 2
    return flops, nbytes + r * 3 * 4 + n * 4 + r * 4
