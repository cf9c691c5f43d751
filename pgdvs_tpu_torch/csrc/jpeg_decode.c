/* Baseline JPEG decoding, equal bit for bit to libjpeg-turbo's default
 * decompression (what np.array(PIL.Image.open(f)) gives for a JPEG file).
 *
 * A host helper of pgdvs_tpu_torch.data.image_io.read_image, compiled with
 * the host C compiler and loaded with ctypes. It takes SOF0 / SOF1 frames of
 * 8-bit Huffman-coded sequential data with 1 component (grey) or 3 (YCbCr,
 * or RGB where libjpeg would say so), the luma sampling 1x1, 2x1 or 2x2 over
 * chroma 1x1, restart intervals, several DQT / DHT segments, 8- and 16-bit
 * quantisation tables, interleaved and single-component scans. Everything
 * else is refused with a message: progressive, lossless, hierarchical and
 * arithmetic-coded frames, 12-bit samples, 2 or 4 components, other
 * sampling factors; corrupt or truncated data is an error (Pillow raises
 * on a truncated file).
 *
 * The arithmetic is libjpeg-turbo's C code, with which its SIMD paths agree
 * bit for bit:
 *   jidctint.c  jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) and the
 *               post-IDCT range limit of jdmaster.c (x & 1023, wrapped);
 *   jdsample.c  h2v1_fancy_upsample / h2v2_fancy_upsample (biases 1 / 2
 *               and 8 / 7), box replication where a component's
 *               downsampled width is 2 or less, on each component's
 *               downsampled width; the context rows above the first row
 *               and below the last repeat them (jdmainct.c);
 *   jdcolor.c   ycc_rgb_convert's fixed-point tables (SCALEBITS 16).
 * Pillow decodes with do_fancy_upsampling on, so merged upsampling
 * (jdmerge.c) is never used. EXIF orientation is ignored, as
 * np.array(PIL.Image.open(f)) ignores it.
 */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { JD_OK = 0, JD_BAD = 1, JD_UNSUPPORTED = 2 };

#define LOOK_BITS 9

typedef struct {
    uint8_t look_len[1 << LOOK_BITS]; /* 0: the code is longer than LOOK_BITS */
    uint8_t look_sym[1 << LOOK_BITS];
    int32_t maxcode[18];              /* largest code of each length, -1 if none */
    int32_t valoffset[18];
    uint8_t huffval[256];
    int present;
} huff_t;

typedef struct {
    int id, h, v, tq;
    int bw, bh;       /* blocks per row / column, the MCU grid's padding included */
    int16_t *coef;    /* bw * bh blocks of 64 coefficients in natural order */
    uint16_t q[64];   /* its quantisation table, latched at its first scan (jdinput.c) */
    int latched, dc_pred, td, ta;
} comp_t;

typedef struct {
    const uint8_t *data;
    int64_t size, pos;
    int width, height, ncomp, hmax, vmax, mcux, mcuy;
    int frame_seen, scans, jfif, adobe, adobe_transform, restart_interval;
    comp_t comp[3];
    uint16_t quant[4][64];
    int qpresent[4];
    huff_t dc[4], ac[4];
    uint64_t acc;     /* bit buffer, next bit at bit 63 */
    int nbits, marker_hit;
    char *err;
    int64_t errlen;
} dec_t;

/* the zig-zag order, with 16 guard entries as libjpeg's jpeg_natural_order */
static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

static int fail(dec_t *d, int code, const char *fmt, ...)
{
    va_list ap;
    va_start(ap, fmt);
    if (d->errlen > 0) vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
    return code;
}

/* ------------------------------------------------------------- segments */

static int read_u16(dec_t *d, int *out)
{
    if (d->pos + 2 > d->size) return fail(d, JD_BAD, "truncated: a marker segment is cut off");
    *out = (d->data[d->pos] << 8) | d->data[d->pos + 1];
    d->pos += 2;
    return JD_OK;
}

/* the body of the segment at d->pos (after its marker): its start and length */
static int segment(dec_t *d, int64_t *start, int *len)
{
    int rc = read_u16(d, len);
    if (rc) return rc;
    if (*len < 2) return fail(d, JD_BAD, "marker segment of length %d", *len);
    *len -= 2;
    if (d->pos + *len > d->size) return fail(d, JD_BAD, "truncated: a marker segment is cut off");
    *start = d->pos;
    d->pos += *len;
    return JD_OK;
}

static int parse_sof(dec_t *d)
{
    int64_t s = 0;
    int len = 0, rc = segment(d, &s, &len);
    const uint8_t *p = d->data + s;
    if (rc) return rc;
    if (d->frame_seen) return fail(d, JD_BAD, "a second frame header");
    if (len < 6) return fail(d, JD_BAD, "SOF segment too short");
    if (p[0] != 8)
        return fail(d, JD_UNSUPPORTED, "%d-bit samples (only 8-bit JPEG is decoded)", p[0]);
    d->height = (p[1] << 8) | p[2];
    d->width = (p[3] << 8) | p[4];
    d->ncomp = p[5];
    if (d->height == 0)
        return fail(d, JD_UNSUPPORTED, "image height 0 (a DNL marker) is not decoded");
    if (d->width == 0) return fail(d, JD_BAD, "image width 0");
    if (d->ncomp != 1 && d->ncomp != 3)
        return fail(d, JD_UNSUPPORTED, "%d components (only 1 or 3 are decoded)", d->ncomp);
    if (len < 6 + 3 * d->ncomp) return fail(d, JD_BAD, "SOF segment too short");
    d->hmax = d->vmax = 1;
    for (int c = 0; c < d->ncomp; ++c) {
        comp_t *cp = &d->comp[c];
        cp->id = p[6 + 3 * c];
        cp->h = p[7 + 3 * c] >> 4;
        cp->v = p[7 + 3 * c] & 15;
        cp->tq = p[8 + 3 * c];
        if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4 || cp->tq > 3)
            return fail(d, JD_BAD, "component %d: sampling %dx%d, table %d", c, cp->h, cp->v,
                        cp->tq);
        if (cp->h > d->hmax) d->hmax = cp->h;
        if (cp->v > d->vmax) d->vmax = cp->v;
    }
    if (d->ncomp == 3) {
        const comp_t *c = d->comp;
        int luma_ok = (c[0].h == 1 && c[0].v == 1) || (c[0].h == 2 && c[0].v == 1) ||
                      (c[0].h == 2 && c[0].v == 2);
        if (!luma_ok || c[1].h != 1 || c[1].v != 1 || c[2].h != 1 || c[2].v != 1)
            return fail(d, JD_UNSUPPORTED,
                        "sampling factors %dx%d, %dx%d, %dx%d (decoded: 1x1, 2x1 or 2x2 "
                        "over 1x1, 1x1)", c[0].h, c[0].v, c[1].h, c[1].v, c[2].h, c[2].v);
    }
    d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    d->frame_seen = 1;
    return JD_OK;
}

static int parse_dqt(dec_t *d)
{
    int64_t s = 0;
    int len = 0, rc = segment(d, &s, &len);
    const uint8_t *p = d->data + s, *end = p + len;
    if (rc) return rc;
    while (p < end) {
        int pq = p[0] >> 4, tq = p[0] & 15;
        ++p;
        if (pq > 1 || tq > 3) return fail(d, JD_BAD, "DQT precision %d, table %d", pq, tq);
        if (end - p < 64 * (pq + 1)) return fail(d, JD_BAD, "DQT segment too short");
        for (int k = 0; k < 64; ++k) {
            int q = pq ? (p[2 * k] << 8) | p[2 * k + 1] : p[k];
            d->quant[tq][natural_order[k]] = (uint16_t)q;
        }
        p += 64 * (pq + 1);
        d->qpresent[tq] = 1;
    }
    return JD_OK;
}

/* jdhuff.c jpeg_make_d_derived_tbl, with a LOOK_BITS-bit lookahead table */
static int build_huff(dec_t *d, huff_t *t, const uint8_t *bits, const uint8_t *vals, int nvals)
{
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return fail(d, JD_BAD, "bad Huffman table");
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (bits[l - 1]) {
            t->valoffset[l] = p - huffcode[p];
            p += bits[l - 1];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0x7fffffff;
    memcpy(t->huffval, vals, (size_t)nvals);
    memset(t->look_len, 0, sizeof t->look_len);
    p = 0;
    for (int l = 1; l <= LOOK_BITS; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++p) {
            int look = huffcode[p] << (LOOK_BITS - l);
            for (int k = 0; k < (1 << (LOOK_BITS - l)); ++k) {
                t->look_len[look + k] = (uint8_t)l;
                t->look_sym[look + k] = vals[p];
            }
        }
    }
    t->present = 1;
    return JD_OK;
}

static int parse_dht(dec_t *d)
{
    int64_t s = 0;
    int len = 0, rc = segment(d, &s, &len);
    const uint8_t *p = d->data + s, *end = p + len;
    if (rc) return rc;
    while (p < end) {
        if (end - p < 17) return fail(d, JD_BAD, "DHT segment too short");
        int tc = p[0] >> 4, th = p[0] & 15, n = 0;
        for (int l = 0; l < 16; ++l) n += p[1 + l];
        if (tc > 1 || th > 3 || n > 256 || end - p < 17 + n)
            return fail(d, JD_BAD, "bad DHT segment (class %d, table %d, %d codes)", tc, th, n);
        rc = build_huff(d, tc ? &d->ac[th] : &d->dc[th], p + 1, p + 17, n);
        if (rc) return rc;
        p += 17 + n;
    }
    return JD_OK;
}

/* jdmarker.c examine_app0 / examine_app14: what default_decompress_parms reads */
static int parse_app(dec_t *d, int marker)
{
    int64_t s = 0;
    int len = 0, rc = segment(d, &s, &len);
    const uint8_t *p = d->data + s;
    if (rc) return rc;
    if (marker == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) d->jfif = 1;
    if (marker == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
        d->adobe = 1;
        d->adobe_transform = p[11];
    }
    return JD_OK;
}

/* ----------------------------------------------------------- bit reader */

/* top the bit buffer up to more than 56 bits; a marker stops the reading
 * and zeros are fed past it, as libjpeg does; the end of the data before a
 * marker is a truncated file */
static int fill(dec_t *d)
{
    while (d->nbits <= 56) {
        uint64_t b = 0;
        if (!d->marker_hit) {
            if (d->pos >= d->size)
                return fail(d, JD_BAD, "truncated: the scan data ends before its last MCU");
            b = d->data[d->pos];
            if (b == 0xFF) {
                int64_t q = d->pos + 1;
                while (q < d->size && d->data[q] == 0xFF) ++q;
                if (q >= d->size)
                    return fail(d, JD_BAD, "truncated: the scan data ends before its last MCU");
                if (d->data[q] == 0) {
                    d->pos = q + 1;
                } else {
                    d->marker_hit = 1;
                    d->pos = q - 1; /* at the 0xFF before the marker code */
                    b = 0;
                }
            } else {
                ++d->pos;
            }
        }
        d->acc |= b << (56 - d->nbits);
        d->nbits += 8;
    }
    return JD_OK;
}

static inline int decode_symbol(dec_t *d, const huff_t *t, int *sym)
{
    if (d->nbits < 16) {
        int rc = fill(d);
        if (rc) return rc;
    }
    int look = (int)(d->acc >> (64 - LOOK_BITS));
    int l = t->look_len[look];
    if (l) {
        d->acc <<= l;
        d->nbits -= l;
        *sym = t->look_sym[look];
        return JD_OK;
    }
    l = LOOK_BITS + 1;
    int32_t code = (int32_t)(d->acc >> (64 - l));
    while (code > t->maxcode[l]) {
        ++l;
        if (l > 16) return fail(d, JD_BAD, "corrupt data: no Huffman code matches");
        code = (int32_t)(d->acc >> (64 - l));
    }
    d->acc <<= l;
    d->nbits -= l;
    *sym = t->huffval[(code + t->valoffset[l]) & 0xFF];
    return JD_OK;
}

/* the next s bits as the signed value they code (HUFF_EXTEND) */
static inline int receive_extend(dec_t *d, int s, int *v)
{
    if (s == 0) {
        *v = 0;
        return JD_OK;
    }
    if (d->nbits < s) {
        int rc = fill(d);
        if (rc) return rc;
    }
    int x = (int)(d->acc >> (64 - s));
    d->acc <<= s;
    d->nbits -= s;
    *v = x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
    return JD_OK;
}

static int decode_block(dec_t *d, comp_t *c, int16_t *blk)
{
    int s = 0, v = 0, rc;
    const huff_t *dc = &d->dc[c->td], *ac = &d->ac[c->ta];
    if ((rc = decode_symbol(d, dc, &s))) return rc;
    if (s > 15) return fail(d, JD_BAD, "corrupt data: DC magnitude %d", s);
    if ((rc = receive_extend(d, s, &v))) return rc;
    c->dc_pred += v;
    blk[0] = (int16_t)c->dc_pred;
    for (int k = 1; k < 64; ++k) {
        if ((rc = decode_symbol(d, ac, &s))) return rc;
        int r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            if ((rc = receive_extend(d, s, &v))) return rc;
            blk[natural_order[k]] = (int16_t)v;
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    return JD_OK;
}

/* align to the byte, then read the expected RSTn marker (jdhuff.c
 * process_restart) */
static int restart(dec_t *d, int n)
{
    d->acc = 0;
    d->nbits = 0;
    d->marker_hit = 0;
    if (d->pos + 1 >= d->size) return fail(d, JD_BAD, "truncated: a restart marker is missing");
    int64_t q = d->pos;
    if (d->data[q] != 0xFF) return fail(d, JD_BAD, "corrupt data: no restart marker");
    while (q < d->size && d->data[q] == 0xFF) ++q;
    if (q >= d->size) return fail(d, JD_BAD, "truncated: a restart marker is missing");
    if (d->data[q] != 0xD0 + (n & 7))
        return fail(d, JD_BAD, "corrupt data: marker 0x%02X where RST%d was expected",
                    d->data[q], n & 7);
    d->pos = q + 1;
    for (int c = 0; c < d->ncomp; ++c) d->comp[c].dc_pred = 0;
    return JD_OK;
}

static int parse_sos(dec_t *d)
{
    int64_t s = 0;
    int len = 0, rc = segment(d, &s, &len);
    const uint8_t *p = d->data + s;
    comp_t *scomp[3];
    if (rc) return rc;
    if (!d->frame_seen) return fail(d, JD_BAD, "SOS before the frame header");
    if (len < 1) return fail(d, JD_BAD, "SOS segment too short");
    int ns = p[0];
    if (ns < 1 || ns > d->ncomp || len < 4 + 2 * ns)
        return fail(d, JD_BAD, "SOS with %d components", ns);
    for (int i = 0; i < ns; ++i) {
        int id = p[1 + 2 * i], ci = -1;
        for (int c = 0; c < d->ncomp; ++c)
            if (d->comp[c].id == id) ci = c;
        if (ci < 0) return fail(d, JD_BAD, "SOS names component id %d, not in the frame", id);
        scomp[i] = &d->comp[ci];
        scomp[i]->td = p[2 + 2 * i] >> 4;
        scomp[i]->ta = p[2 + 2 * i] & 15;
        if (scomp[i]->td > 3 || scomp[i]->ta > 3 || !d->dc[scomp[i]->td].present ||
            !d->ac[scomp[i]->ta].present)
            return fail(d, JD_BAD, "SOS names a Huffman table that is not defined");
        if (!scomp[i]->latched) {
            if (!d->qpresent[scomp[i]->tq])
                return fail(d, JD_BAD, "quantisation table %d is not defined", scomp[i]->tq);
            memcpy(scomp[i]->q, d->quant[scomp[i]->tq], sizeof scomp[i]->q);
            scomp[i]->latched = 1;
        }
        scomp[i]->dc_pred = 0;
    }
    const uint8_t *q = p + 1 + 2 * ns;
    if (q[0] != 0 || q[1] != 63 || q[2] != 0)
        return fail(d, JD_BAD, "sequential scan with Ss %d, Se %d, Ah/Al 0x%02X", q[0], q[1],
                    q[2]);
    for (int c = 0; c < d->ncomp; ++c) {
        comp_t *cp = &d->comp[c];
        if (!cp->coef) {
            cp->bw = d->mcux * cp->h;
            cp->bh = d->mcuy * cp->v;
            cp->coef = (int16_t *)calloc((size_t)cp->bw * cp->bh * 64, sizeof(int16_t));
            if (!cp->coef) return fail(d, JD_BAD, "out of memory");
        }
    }
    d->acc = 0;
    d->nbits = 0;
    d->marker_hit = 0;
    int64_t n_mcu, mcu_w;
    if (ns == 1) { /* non-interleaved: one block per MCU over the component's own grid */
        comp_t *c = scomp[0];
        int cw = (d->width * c->h + d->hmax - 1) / d->hmax;
        int ch = (d->height * c->v + d->vmax - 1) / d->vmax;
        mcu_w = (cw + 7) / 8;
        n_mcu = mcu_w * ((ch + 7) / 8);
    } else {
        mcu_w = d->mcux;
        n_mcu = (int64_t)d->mcux * d->mcuy;
    }
    int rst = 0;
    for (int64_t m = 0; m < n_mcu; ++m) {
        if (d->restart_interval && m > 0 && m % d->restart_interval == 0) {
            if ((rc = restart(d, rst++))) return rc;
        }
        int64_t my = m / mcu_w, mx = m % mcu_w;
        if (ns == 1) {
            comp_t *c = scomp[0];
            if ((rc = decode_block(d, c, c->coef + (my * c->bw + mx) * 64))) return rc;
            continue;
        }
        for (int i = 0; i < ns; ++i) {
            comp_t *c = scomp[i];
            for (int by = 0; by < c->v; ++by)
                for (int bx = 0; bx < c->h; ++bx) {
                    int64_t b = (my * c->v + by) * c->bw + mx * c->h + bx;
                    if ((rc = decode_block(d, c, c->coef + b * 64))) return rc;
                }
        }
    }
    /* past the scan data to the next marker */
    if (!d->marker_hit) {
        while (d->pos + 1 < d->size &&
               !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] != 0 &&
                 d->data[d->pos + 1] != 0xFF))
            ++d->pos;
    }
    ++d->scans;
    return JD_OK;
}

/* Parse markers from SOI; stop after the frame header (header_only) or at EOI. */
static int parse(dec_t *d, int header_only)
{
    int rc;
    if (d->size < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
        return fail(d, JD_BAD, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    for (;;) {
        if (d->pos >= d->size)
            return fail(d, JD_BAD, d->scans ? "truncated: no EOI marker"
                                            : "truncated before the scan data");
        if (d->data[d->pos] != 0xFF)
            return fail(d, JD_BAD, "corrupt data: 0x%02X where a marker was expected",
                        d->data[d->pos]);
        while (d->pos < d->size && d->data[d->pos] == 0xFF) ++d->pos;
        if (d->pos >= d->size) return fail(d, JD_BAD, "truncated: a marker is cut off");
        int m = d->data[d->pos++];
        switch (m) {
        case 0xC0:
        case 0xC1:
            if ((rc = parse_sof(d))) return rc;
            if (header_only) return JD_OK;
            break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
            return fail(d, JD_UNSUPPORTED, "progressive JPEG (SOF%d) is not decoded", m - 0xC0);
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
            return fail(d, JD_UNSUPPORTED, "lossless JPEG (SOF%d) is not decoded", m - 0xC0);
        case 0xC5:
            return fail(d, JD_UNSUPPORTED, "hierarchical JPEG (SOF5) is not decoded");
        case 0xC9:
        case 0xCC:
        case 0xCD:
            return fail(d, JD_UNSUPPORTED, "arithmetic-coded JPEG (marker 0x%02X) is not decoded",
                        m);
        case 0xC4:
            if ((rc = parse_dht(d))) return rc;
            break;
        case 0xDB:
            if ((rc = parse_dqt(d))) return rc;
            break;
        case 0xDD: {
            int64_t s = 0;
            int len = 0;
            if ((rc = segment(d, &s, &len))) return rc;
            if (len < 2) return fail(d, JD_BAD, "DRI segment too short");
            d->restart_interval = (d->data[s] << 8) | d->data[s + 1];
            break;
        }
        case 0xDA:
            if ((rc = parse_sos(d))) return rc;
            break;
        case 0xD9:
            if (!d->frame_seen || !d->scans) return fail(d, JD_BAD, "EOI before any scan");
            return JD_OK;
        case 0xD8:
            return fail(d, JD_BAD, "a second SOI marker");
        case 0x01:
            break; /* TEM: no segment */
        default:
            if (m >= 0xD0 && m <= 0xD7)
                return fail(d, JD_BAD, "corrupt data: RST%d outside a scan", m - 0xD0);
            if (m >= 0xE0 && m <= 0xEF) {
                if ((rc = parse_app(d, m))) return rc;
            } else {
                int64_t s = 0;
                int len = 0;
                if ((rc = segment(d, &s, &len))) return rc;  /* COM, DNL, JPGn, ... */
            }
        }
    }
}

/* ------------------------------------------------------------- the IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* jdmaster.c's post-IDCT range limit: the value masked to 10 bits, read as
 * [-512, 511], plus 128, clamped to [0, 255] */
static inline uint8_t idct_limit(int64_t x)
{
    int v = (int)(((x & 1023) ^ 512) - 512) + 128;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* jidctint.c jpeg_idct_islow: one block, dequantised, into out (stride) */
static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int64_t stride)
{
    int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
    int ws[64];
    for (int c = 0; c < 8; ++c) { /* pass 1: columns */
        const int16_t *ip = in + c;
        const uint16_t *qp = q + c;
        int *wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (int)(ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        z2 = (int64_t)ip[16] * qp[16];
        z3 = (int64_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        tmp0 = (z2 + z3) * (1 << CONST_BITS);
        tmp1 = (z2 - z3) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; ++r) { /* pass 2: rows */
        const int *wp = ws + 8 * r;
        uint8_t *op = out + r * stride;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = idct_limit(DESCALE(tmp10 + tmp3, sh));
        op[7] = idct_limit(DESCALE(tmp10 - tmp3, sh));
        op[1] = idct_limit(DESCALE(tmp11 + tmp2, sh));
        op[6] = idct_limit(DESCALE(tmp11 - tmp2, sh));
        op[2] = idct_limit(DESCALE(tmp12 + tmp1, sh));
        op[5] = idct_limit(DESCALE(tmp12 - tmp1, sh));
        op[3] = idct_limit(DESCALE(tmp13 + tmp0, sh));
        op[4] = idct_limit(DESCALE(tmp13 - tmp0, sh));
    }
}

/* a component's samples: [bh * 8, bw * 8], row stride bw * 8 */
static uint8_t *component_plane(const comp_t *c)
{
    int64_t stride = (int64_t)c->bw * 8;
    uint8_t *plane = (uint8_t *)malloc((size_t)stride * c->bh * 8);
    if (!plane) return NULL;
    for (int by = 0; by < c->bh; ++by)
        for (int bx = 0; bx < c->bw; ++bx)
            idct_islow(c->coef + ((int64_t)by * c->bw + bx) * 64, c->q,
                       plane + (int64_t)by * 8 * stride + bx * 8, stride);
    return plane;
}

/* ------------------------------------------------------------ upsampling */

/* one chroma plane (downsampled dw x dh, row stride `stride`) brought to
 * full size [height, width] as jdsample.c does for the luma sampling
 * hmax x vmax over a 1x1 chroma */
static int upsample(const uint8_t *in, int64_t stride, int dw, int dh, int hmax, int vmax,
                    int width, int height, uint8_t *out)
{
    int fancy = dw > 2;  /* jinit_upsampler: fancy only past 2 columns */
    int *row = (int *)malloc(sizeof(int) * (size_t)(2 * dw + 2));
    if (!row) return 1;
    for (int y = 0; y < height; ++y) {
        uint8_t *op = out + (int64_t)y * width;
        if (hmax == 1) {
            memcpy(op, in + (int64_t)y * stride, (size_t)width);
            continue;
        }
        if (vmax == 1) {
            const uint8_t *ip = in + (int64_t)y * stride;
            if (!fancy) {
                for (int x = 0; x < width; ++x) op[x] = ip[x >> 1];
                continue;
            }
            /* h2v1_fancy_upsample */
            row[0] = ip[0];
            row[1] = (ip[0] * 3 + ip[1] + 2) >> 2;
            for (int i = 1; i < dw - 1; ++i) {
                row[2 * i] = (ip[i] * 3 + ip[i - 1] + 1) >> 2;
                row[2 * i + 1] = (ip[i] * 3 + ip[i + 1] + 2) >> 2;
            }
            row[2 * dw - 2] = (ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2;
            row[2 * dw - 1] = ip[dw - 1];
            for (int x = 0; x < width; ++x) op[x] = (uint8_t)row[x];
            continue;
        }
        int r = y >> 1;
        if (!fancy) {
            const uint8_t *ip = in + (int64_t)r * stride;
            for (int x = 0; x < width; ++x) op[x] = ip[x >> 1];
            continue;
        }
        /* h2v2_fancy_upsample: the nearer row and the row above (even
         * output rows) or below (odd), repeated past the edges */
        int r1 = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
        const uint8_t *i0 = in + (int64_t)r * stride, *i1 = in + (int64_t)r1 * stride;
        int last, this_, next;
        this_ = i0[0] * 3 + i1[0];
        next = i0[1] * 3 + i1[1];
        row[0] = (this_ * 4 + 8) >> 4;
        row[1] = (this_ * 3 + next + 7) >> 4;
        last = this_;
        this_ = next;
        for (int i = 1; i < dw - 1; ++i) {
            next = i0[i + 1] * 3 + i1[i + 1];
            row[2 * i] = (this_ * 3 + last + 8) >> 4;
            row[2 * i + 1] = (this_ * 3 + next + 7) >> 4;
            last = this_;
            this_ = next;
        }
        row[2 * dw - 2] = (this_ * 3 + last + 8) >> 4;
        row[2 * dw - 1] = (this_ * 4 + 7) >> 4;
        for (int x = 0; x < width; ++x) op[x] = (uint8_t)row[x];
    }
    free(row);
    return 0;
}

/* ------------------------------------------------------- colour convert */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* jdcolor.c build_ycc_rgb_table + ycc_rgb_convert */
static void ycc_to_rgb(const uint8_t *y, const uint8_t *cb, const uint8_t *cr, int64_t n,
                       uint8_t *out)
{
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = (-FIX(0.71414)) * x;
        cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    for (int64_t i = 0; i < n; ++i) {
        int yy = y[i], b = cb[i], r = cr[i];
        out[3 * i] = clamp255(yy + cr_r[r]);
        out[3 * i + 1] = clamp255(yy + (int)((cb_g[b] + cr_g[r]) >> SCALEBITS));
        out[3 * i + 2] = clamp255(yy + cb_b[b]);
    }
}

/* jdapimin.c default_decompress_parms: whether three components are RGB */
static int is_rgb(const dec_t *d)
{
    if (d->jfif) return 0;
    if (d->adobe) return d->adobe_transform == 0;
    return d->comp[0].id == 'R' && d->comp[1].id == 'G' && d->comp[2].id == 'B';
}

static void release(dec_t *d)
{
    for (int c = 0; c < 3; ++c) {
        free(d->comp[c].coef);
        d->comp[c].coef = NULL;
    }
}

/* ------------------------------------------------------------ interface */

/* Parse up to the frame header: hwc = (height, width, channels). Returns 0,
 * 1 for a malformed or truncated file, 2 for one that is not decoded; the
 * message is written to err. */
int jpeg_header(const uint8_t *data, int64_t size, int32_t *hwc, char *err, int64_t errlen)
{
    dec_t *d = (dec_t *)calloc(1, sizeof(dec_t));
    if (!d) return JD_BAD;
    d->data = data;
    d->size = size;
    d->err = err;
    d->errlen = errlen;
    int rc = parse(d, 1);
    if (!rc && !d->frame_seen) rc = fail(d, JD_BAD, "no frame header");
    if (!rc) {
        hwc[0] = d->height;
        hwc[1] = d->width;
        hwc[2] = d->ncomp;
    }
    free(d);
    return rc;
}

/* Decode into out: [height, width] grey or [height, width, 3] RGB uint8
 * (out_size bytes, as jpeg_header gave). Returns as jpeg_header. */
int jpeg_decode(const uint8_t *data, int64_t size, uint8_t *out, int64_t out_size, char *err,
                int64_t errlen)
{
    dec_t *d = (dec_t *)calloc(1, sizeof(dec_t));
    uint8_t *planes[3] = {NULL, NULL, NULL}, *full[2] = {NULL, NULL};
    int rc;
    if (!d) return JD_BAD;
    d->data = data;
    d->size = size;
    d->err = err;
    d->errlen = errlen;
    if ((rc = parse(d, 0))) goto done;
    int64_t w = d->width, h = d->height;
    if (out_size != w * h * d->ncomp) {
        rc = fail(d, JD_BAD, "output buffer of %lld bytes, expected %lld", (long long)out_size,
                  (long long)(w * h * d->ncomp));
        goto done;
    }
    for (int c = 0; c < d->ncomp; ++c) {
        if (!(planes[c] = component_plane(&d->comp[c]))) {
            rc = fail(d, JD_BAD, "out of memory");
            goto done;
        }
    }
    int64_t stride0 = (int64_t)d->comp[0].bw * 8;
    if (d->ncomp == 1) {
        for (int64_t y = 0; y < h; ++y) memcpy(out + y * w, planes[0] + y * stride0, (size_t)w);
        goto done;
    }
    uint8_t *luma = (uint8_t *)malloc((size_t)(w * h));
    for (int c = 0; c < 2; ++c) full[c] = (uint8_t *)malloc((size_t)(w * h));
    if (!luma || !full[0] || !full[1]) {
        free(luma);
        rc = fail(d, JD_BAD, "out of memory");
        goto done;
    }
    for (int64_t y = 0; y < h; ++y) memcpy(luma + y * w, planes[0] + y * stride0, (size_t)w);
    for (int c = 1; c < 3; ++c) {
        int dw = (int)((w + d->hmax - 1) / d->hmax), dh = (int)((h + d->vmax - 1) / d->vmax);
        if (upsample(planes[c], (int64_t)d->comp[c].bw * 8, dw, dh, d->hmax, d->vmax, (int)w,
                     (int)h, full[c - 1])) {
            free(luma);
            rc = fail(d, JD_BAD, "out of memory");
            goto done;
        }
    }
    if (is_rgb(d)) {
        for (int64_t i = 0; i < w * h; ++i) {
            out[3 * i] = luma[i];
            out[3 * i + 1] = full[0][i];
            out[3 * i + 2] = full[1][i];
        }
    } else {
        ycc_to_rgb(luma, full[0], full[1], w * h, out);
    }
    free(luma);
done:
    for (int c = 0; c < 3; ++c) free(planes[c]);
    free(full[0]);
    free(full[1]);
    release(d);
    free(d);
    return rc;
}
