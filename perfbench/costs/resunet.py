"""Operations of GNT's ResUNet over V source images of H x W.

The convolutions' multiply-adds from their shapes (2 FLOP each; norms,
activations and the upsampling left out): a 7x7 stride-2 stem, residual
stages of 3, 4 and 6 blocks at 64, 128 and 256 channels (the first block of
each at stride 2 with a 1x1 projection), then the decoder's two upsampling
levels to 32 channels and a 1x1 output convolution.
"""


def _out(n, k, stride):
    return (n + 2 * ((k - 1) // 2) - k) // stride + 1


def flops(v, h, w, out_channels=32):
    total = 0

    def conv(cin, cout, k, stride, hw):
        nonlocal total
        oh, ow = _out(hw[0], k, stride), _out(hw[1], k, stride)
        total += 2 * cin * cout * k * k * oh * ow
        return oh, ow

    hw = conv(3, 64, 7, 2, (h, w))
    cin = 64
    for planes, blocks in ((64, 3), (128, 4), (256, 6)):
        conv(cin, planes, 1, 2, hw)
        hw = conv(cin, planes, 3, 2, hw)
        conv(planes, planes, 3, 1, hw)
        for _ in range(1, blocks):
            conv(planes, planes, 3, 1, hw)
            conv(planes, planes, 3, 1, hw)
        cin = planes
    hw = (2 * hw[0], 2 * hw[1])
    conv(256, 128, 3, 1, hw)
    conv(256, 128, 3, 1, hw)
    hw = (2 * hw[0], 2 * hw[1])
    conv(128, 64, 3, 1, hw)
    conv(128, out_channels, 3, 1, hw)
    conv(out_channels, out_channels, 1, 1, hw)
    return v * total
