/* PNG scanline un-filtering (PNG spec, section 9: filter method 0).
 *
 * A host helper of pgdvs_tpu_torch.data.image_io.read_png, compiled with the
 * host C compiler and loaded with ctypes. Its plain version is
 * image_io.unfilter_plain (numpy), which the tests hold it against.
 */

#include <stdint.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

/* src: height scanlines of 1 + stride bytes (the filter type, then the
 * filtered bytes), as inflated from the IDAT stream; dst: height rows of
 * stride bytes; bpp: bytes per complete pixel, at least 1. Returns 0, or
 * 1 + the index of the first row whose filter type is not 0-4. */
int png_unfilter(const uint8_t *src, uint8_t *dst, int64_t height, int64_t stride, int bpp)
{
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t *in = src + y * (stride + 1) + 1;
        uint8_t *out = dst + y * stride;
        const uint8_t *up = y > 0 ? out - stride : NULL;
        int64_t i;
        switch (src[y * (stride + 1)]) {
        case 0:
            memcpy(out, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < stride && i < bpp; ++i) out[i] = in[i];
            for (; i < stride; ++i) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            if (up)
                for (i = 0; i < stride; ++i) out[i] = (uint8_t)(in[i] + up[i]);
            else
                memcpy(out, in, (size_t)stride);
            break;
        case 3:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                out[i] = (uint8_t)(in[i] + paeth(a, b, c));
            }
            break;
        default:
            return (int)(y + 1);
        }
    }
    return 0;
}
