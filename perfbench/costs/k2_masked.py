"""Operations and bytes of K2 in its masked mode, one 2048-ray tile.

``gnt_fused_mono3`` on the quad sampler's features with the dynamic mask:
the GNT's dense products and the operands at the function's contract,
frozen from ``chip_smoke.gnt_cost(v, r, s, c, masked=True)``.
"""

NETWIDTH, DEPTH = 64, 8


def cost(v, r, s, c):
    """(FLOP, bytes) of one K2 forward over R rays x S samples x V views
    with C input channels: the dense products only (softmax, layer norms and
    embeddings left out, so the bound is a lower one), with the kernels'
    weight compositions (wk@wv, wk@wa0, wq@wa0, p1@wa0; exact by
    linearity); bytes read once (bf16 features, f32 points / view code /
    centres, the uint8 mask) and written once (f32 rgb, weights, count)."""
    n, nw, depth = r * s, NETWIDTH, DEPTH
    mac = n * v * (c * nw + nw * nw)                          # rgbfeat_fc_0/1
    mac += depth * n * v * (nw * (nw + 8) + 8 * (nw + 8) + 4 * 8 + 8 * nw)
    mac += depth * n * (nw * 8 + nw * nw + 2 * nw * 4 * nw)   # q side, out, ff
    mac += depth // 2 * n * ((nw + 126) * nw + nw * nw)       # q_fc on even blocks
    mac += depth * n * (nw * 3 * nw + nw * nw + 2 * nw * 4 * nw)  # qkv, out, ff
    mac += depth * r * 2 * s * s * nw                         # QK^T and PV, 4 heads
    mac += r * nw * 3                                         # rgb_fc
    nbytes = v * n * c * 2 + n * 3 * 4 + r * 63 * 4 + (v + 1) * 3 * 4
    nbytes += v * n                                           # the uint8 mask
    nbytes += r * 3 * 4 + n * 4 + r * 4
    return 2 * mac, nbytes
