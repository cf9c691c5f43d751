"""A baseline JPEG writer in numpy, for the scene's frames.

A frozen copy of ``chip_smoke.encode_jpeg``: YCbCr, 4:2:0 (chroma the mean
of each 2x2), the float DCT, the ITU-T T.81 Annex K quantisation tables
scaled to a quality, and the Annex K Huffman tables.
"""

import numpy as np

# zig-zag position k -> natural (row-major) index of the 8x8 block
JPEG_NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU-T T.81 Annex K.1 quantisation tables (natural order)
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
JPEG_CHROMA_Q = np.full(64, 99)
JPEG_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3 Huffman tables: (code counts per length 1-16, symbols)
JPEG_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
JPEG_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
JPEG_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
    "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
    "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9fa"))
JPEG_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a16"
    "2434e125f11718191a262728292a35363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9"
    "eaf2f3f4f5f6f7f8f9fa"))


def _jpeg_quant(base, quality):
    """libjpeg's jpeg_quality_scaling of an Annex K table, baseline-clamped."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huff_codes(table):
    """symbol -> (code, length) arrays of the canonical code of ``table``."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix():
    n = np.arange(8)
    c = np.sqrt(2.0 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2.0)
    return c


def encode_jpeg(rgb, quality=95):
    """Baseline JFIF bytes of a uint8 [H, W, 3] image: YCbCr, 4:2:0 (chroma
    the mean of each 2x2), the float DCT, the Annex K tables scaled to
    ``quality`` and the Annex K Huffman tables. numpy only."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    sub = [c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3)) for c in (cb, cr)]
    qt = [_jpeg_quant(JPEG_LUMA_Q, quality), _jpeg_quant(JPEG_CHROMA_Q, quality)]
    dct = _dct_matrix()

    def blocks(plane, q):
        """[rows, cols, 64] quantised coefficients in zig-zag order."""
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blk = (plane - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ blk @ dct.T
        return np.rint(coef.reshape(bh, bw, 64) / q)[..., JPEG_NATURAL_ORDER].astype(np.int64)

    yq, cbq, crq = blocks(y, qt[0]), blocks(sub[0], qt[1]), blocks(sub[1], qt[1])
    my, mx = ph // 16, pw // 16
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    yq = yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    seq = np.concatenate([yq, cbq[:, :, None], crq[:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    nblk = seq.shape[0]

    dc = seq[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    codes = [_huff_codes(t) for t in (JPEG_DC_LUMA, JPEG_AC_LUMA, JPEG_DC_CHROMA, JPEG_AC_CHROMA)]
    is_chroma = comp > 0

    def category(v):
        a = np.abs(v)
        return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)

    # events: (block, key, value, length)
    ev_blk, ev_key, ev_val, ev_len = [], [], [], []
    s = category(diff)
    dcode = np.where(is_chroma, codes[2][0][s], codes[0][0][s])
    dlen = np.where(is_chroma, codes[2][1][s], codes[0][1][s])
    ev_blk.append(np.arange(nblk))
    ev_key.append(np.zeros(nblk, np.int64))
    ev_val.append((dcode << s) | extra(diff, s))
    ev_len.append(dlen + s)
    bi, k = np.nonzero(seq[:, 1:])
    k = k + 1
    prev = np.where(np.r_[True, bi[1:] != bi[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    n_zrl = run // 16
    run = run % 16
    v = seq[bi, k]
    s = category(v)
    ch = is_chroma[bi]
    sym = run * 16 + s
    ev_blk.append(bi)
    ev_key.append(k * 8 + 7)
    ev_val.append((np.where(ch, codes[3][0][sym], codes[1][0][sym]) << s) | extra(v, s))
    ev_len.append(np.where(ch, codes[3][1][sym], codes[1][1][sym]) + s)
    zi = np.repeat(np.arange(bi.size), n_zrl)
    zj = np.arange(zi.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    zch = ch[zi]
    ev_blk.append(bi[zi])
    ev_key.append(k[zi] * 8 + zj)
    ev_val.append(np.where(zch, codes[3][0][0xF0], codes[1][0][0xF0]))
    ev_len.append(np.where(zch, codes[3][1][0xF0], codes[1][1][0xF0]))
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    ev_blk.append(eob)
    ev_key.append(np.full(eob.size, 64 * 8))
    ev_val.append(np.where(is_chroma[eob], codes[3][0][0], codes[1][0][0]))
    ev_len.append(np.where(is_chroma[eob], codes[3][1][0], codes[1][1][0]))
    blk, key = np.concatenate(ev_blk), np.concatenate(ev_key)
    order = np.lexsort((key, blk))
    val, length = np.concatenate(ev_val)[order], np.concatenate(ev_len)[order]
    starts = np.cumsum(length) - length
    total = int(length.sum())
    idx = np.repeat(np.arange(val.size), length)
    j = np.arange(total) - starts[idx]
    bits = ((val[idx] >> (length[idx] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])  # pad with 1s
    data = np.packbits(bits)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).astype(np.uint8).tobytes()

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qt):
        out += seg(0xDB, bytes([t]) + bytes(q[JPEG_NATURAL_ORDER].astype(np.uint8)))
    out += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc_th, (counts, symbols) in ((0x00, JPEG_DC_LUMA), (0x10, JPEG_AC_LUMA),
                                      (0x01, JPEG_DC_CHROMA), (0x11, JPEG_AC_CHROMA)):
        out += seg(0xC4, bytes([tc_th]) + bytes(counts) + bytes(symbols))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + data + b"\xff\xd9"
