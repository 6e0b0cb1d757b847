/* PNG image-data reconstruction, the port's replacement for the part of
 * libpng (and PIL's PNG decoder) that runs after inflate: the row filters
 * undone, Adam7's seven passes put back in place and sub-byte samples
 * unpacked.
 *
 * Input: the inflated IDAT stream of an image of any bit depth (1, 2, 4,
 * 8, 16) and 1-4 samples a pixel, plain or Adam7-interlaced. Output: every
 * sample of the full image, row-major (height, width, channels): one byte
 * a sample at depths up to 8 (the sample's value, not scaled: 0-1 at 1
 * bit, 0-3 at 2, 0-15 at 4), two at 16 (the host's uint16, taken from
 * PNG's big-endian bytes). Scaling, palette lookup and the 16-bit rules
 * are png.py's. Sub-byte samples are packed MSB first, each row padded to
 * a byte; the filters (None, Sub, Up, Average, Paeth) predict from the
 * byte bpp = max(1, bits a pixel / 8) to the left and from the row above
 * in the same pass, which starts from a row of zeros.
 *
 * Build: python -m vision_instance_seg_tpu_torch.data.native.build (also at
 * first use).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

enum { PE_TRUNCATED = -1, PE_FILTER = -2, PE_BUFFER = -3, PE_FORMAT = -4,
       PE_MEMORY = -5 };

static const int adam7[7][4] = {   /* x0, y0, dx, dy */
    {0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

/* Undo one row's filter in place: cur holds the filtered bytes, prev the
 * reconstructed row above (zeros for a pass's first row). */
static int unfilter(int kind, uint8_t *cur, const uint8_t *prev,
                    int64_t stride, int bpp) {
    int64_t i;
    switch (kind) {
    case 0:
        break;
    case 1:
        for (i = bpp; i < stride; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
    case 2:
        for (i = 0; i < stride; i++) cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
    case 3:
        for (i = 0; i < bpp && i < stride; i++)
            cur[i] = (uint8_t)(cur[i] + (prev[i] >> 1));
        for (; i < stride; i++)
            cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
    case 4:
        for (i = 0; i < bpp && i < stride; i++)
            cur[i] = (uint8_t)(cur[i] + prev[i]);
        for (; i < stride; i++)
            cur[i] = (uint8_t)(cur[i] + paeth(cur[i - bpp], prev[i],
                                              prev[i - bpp]));
        break;
    default:
        return PE_FILTER;
    }
    return 0;
}

/* raw: the inflated image data (n bytes). out: height * width * channels
 * samples of (depth == 16 ? 2 : 1) bytes. Returns 0 or an error < 0. */
EXPORT int png_reconstruct(const uint8_t *raw, int64_t n, int32_t width,
                           int32_t height, int32_t depth, int32_t channels,
                           int32_t interlace, uint8_t *out, int64_t out_size) {
    if (width < 1 || height < 1 || channels < 1 || channels > 4
        || (depth != 1 && depth != 2 && depth != 4 && depth != 8
            && depth != 16)
        || (depth < 8 && channels != 1))
        return PE_FORMAT;
    int sb = depth == 16 ? 2 : 1;
    if (out_size < (int64_t)width * height * channels * sb) return PE_BUFFER;
    int bpp = channels * depth / 8;
    if (bpp < 1) bpp = 1;
    int64_t max_stride = ((int64_t)width * channels * depth + 7) / 8;
    uint8_t *rows = (uint8_t *)malloc(2 * (size_t)max_stride + 2);
    if (!rows) return PE_MEMORY;
    int64_t pos = 0;
    int npass = interlace ? 7 : 1;
    int r = 0;
    for (int p = 0; p < npass && !r; p++) {
        int x0 = 0, y0 = 0, dx = 1, dy = 1;
        if (interlace) {
            x0 = adam7[p][0];
            y0 = adam7[p][1];
            dx = adam7[p][2];
            dy = adam7[p][3];
        }
        int64_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
        int64_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;      /* an empty pass has no rows */
        int64_t stride = (pw * channels * depth + 7) / 8;
        uint8_t *prev = rows, *cur = rows + max_stride + 1;
        memset(prev, 0, (size_t)stride);
        for (int64_t y = 0; y < ph; y++) {
            if (pos + 1 + stride > n) {
                r = PE_TRUNCATED;
                break;
            }
            int kind = raw[pos];
            memcpy(cur, raw + pos + 1, (size_t)stride);
            pos += 1 + stride;
            r = unfilter(kind, cur, prev, stride, bpp);
            if (r) break;
            int64_t oy = y0 + y * dy;
            for (int64_t x = 0; x < pw; x++) {
                int64_t o = ((oy * width) + x0 + x * dx) * channels;
                if (depth == 8) {
                    memcpy(out + o, cur + x * channels, (size_t)channels);
                } else if (depth == 16) {
                    uint16_t *o16 = (uint16_t *)out + o;
                    const uint8_t *s = cur + x * channels * 2;
                    for (int c = 0; c < channels; c++)
                        o16[c] = (uint16_t)((s[2 * c] << 8) | s[2 * c + 1]);
                } else {               /* one sample a pixel, MSB first */
                    int64_t bit = x * depth;
                    int shift = 8 - depth - (int)(bit & 7);
                    out[o] = (uint8_t)((cur[bit >> 3] >> shift)
                                       & ((1 << depth) - 1));
                }
            }
            uint8_t *t = prev;
            prev = cur;
            cur = t;
        }
    }
    free(rows);
    return r;
}
