/* The cv2 calls of the traditional augmenter (data/augment.py), computing
 * what OpenCV 5.0.0 computes on 8-bit images, byte for byte. Built by
 * build.py with gcc at first use (-ffp-contract=off: every fused
 * multiply-add below is an explicit fmaf, as cv2's SIMD bodies issue it).
 *
 * warpAffine (constant border 0): the caller passes the inverse map in
 * float32 (cv2 inverts the 2 x 3 matrix in float64, then rounds it). Each
 * output row y takes bx = (float)y * m1 + m2 unfused; a column x below the
 * last multiple of 16 takes sx = fmaf(m0, x, bx) (cv2's vector body), one
 * past it fmaf(x, m0, y * m1) + m2 (its scalar tail); sy likewise.
 *   - INTER_LINEAR on (H, W, 3): x0 = floor(sx), alpha = sx - x0, the
 *     four neighbours (0 where they fall outside the source), lerps
 *     fmaf(alpha, b - a, a) along x, then along y, rounded half to even.
 *   - INTER_NEAREST on (H, W): the source pixel at (rint(sx), rint(sy)),
 *     0 outside.
 * cvtColor RGB2HSV (hue 0..179): cv2's 12-bit integer tables.
 * cvtColor HSV2RGB: float32 with s and v scaled by 1/255, h by 6/180; the
 * columns below the last multiple of 32 of a row take cv2's vector body
 * (v * fmaf(-s, f, 1), truncated), the rest its scalar tail (the same
 * products, rounded half to even).
 * GaussianBlur with k 3 or 5 and sigma 0: cv2's bit-exact 8-bit path,
 * which for these kernels is the binomial [1 2 1] / [1 4 6 4 1] sum,
 * rounded half up, on the reflect-101 border.
 *
 * Every function returns 0, -1 when out of memory, or -2 on an input it
 * does not take. */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#define EXPORT __attribute__((visibility("default")))

static inline uint8_t sat_u8(float v) {
    float r = nearbyintf(v);
    return (uint8_t)(r < 0.f ? 0.f : r > 255.f ? 255.f : r);
}

/* Source coordinates of output pixel (x, y) for the inverse map m. */
static inline void warp_coords(const float *m, int32_t x, int32_t y,
                               int32_t vec_end, float *sx, float *sy) {
    float fx = (float)x, fy = (float)y;
    if (x < vec_end) {
        *sx = fmaf(m[0], fx, fy * m[1] + m[2]);
        *sy = fmaf(m[3], fx, fy * m[4] + m[5]);
    } else {
        *sx = fmaf(fx, m[0], fy * m[1]) + m[2];
        *sy = fmaf(fx, m[3], fy * m[4]) + m[5];
    }
}

/* src (sh, sw, 3) -> dst (dh, dw, 3). */
EXPORT int aug_warp_linear_c3(const uint8_t *src, int32_t sh, int32_t sw,
                              const float *m, uint8_t *dst, int32_t dh,
                              int32_t dw) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1) return -2;
    int32_t vec_end = dw - dw % 16;
    for (int32_t y = 0; y < dh; y++) {
        uint8_t *o = dst + (int64_t)y * dw * 3;
        for (int32_t x = 0; x < dw; x++, o += 3) {
            float sx, sy;
            warp_coords(m, x, y, vec_end, &sx, &sy);
            /* past these bounds every neighbour is border (NaN too) */
            if (!(sx > -2.f && sx < (float)sw + 1.f && sy > -2.f
                  && sy < (float)sh + 1.f)) {
                o[0] = o[1] = o[2] = 0;
                continue;
            }
            float flx = floorf(sx), fly = floorf(sy);
            int32_t x0 = (int32_t)flx, y0 = (int32_t)fly;
            float alpha = sx - flx, beta = sy - fly;
            const uint8_t *p[4];
            for (int k = 0; k < 4; k++) {
                int32_t yy = y0 + (k >> 1), xx = x0 + (k & 1);
                p[k] = (yy >= 0 && yy < sh && xx >= 0 && xx < sw)
                           ? src + ((int64_t)yy * sw + xx) * 3 : NULL;
            }
            for (int c = 0; c < 3; c++) {
                float v00 = p[0] ? p[0][c] : 0.f, v01 = p[1] ? p[1][c] : 0.f;
                float v10 = p[2] ? p[2][c] : 0.f, v11 = p[3] ? p[3][c] : 0.f;
                float f0 = fmaf(alpha, v01 - v00, v00);
                float f1 = fmaf(alpha, v11 - v10, v10);
                o[c] = sat_u8(fmaf(beta, f1 - f0, f0));
            }
        }
    }
    return 0;
}

/* src (sh, sw) -> dst (dh, dw). */
EXPORT int aug_warp_nearest_c1(const uint8_t *src, int32_t sh, int32_t sw,
                               const float *m, uint8_t *dst, int32_t dh,
                               int32_t dw) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1) return -2;
    int32_t vec_end = dw - dw % 16;
    for (int32_t y = 0; y < dh; y++) {
        uint8_t *o = dst + (int64_t)y * dw;
        for (int32_t x = 0; x < dw; x++) {
            float sx, sy;
            warp_coords(m, x, y, vec_end, &sx, &sy);
            float rx = nearbyintf(sx), ry = nearbyintf(sy);
            o[x] = (rx >= 0.f && rx < (float)sw && ry >= 0.f
                    && ry < (float)sh)
                       ? src[(int64_t)ry * sw + (int64_t)rx] : 0;
        }
    }
    return 0;
}

/* n pixels RGB -> HSV, hue 0..179. */
EXPORT int aug_rgb2hsv(const uint8_t *src, int64_t n, uint8_t *dst) {
    enum { SHIFT = 12 };
    int sdiv[256], hdiv[256];
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; i++) {
        sdiv[i] = (int)lrint((255 << SHIFT) / (1. * i));
        hdiv[i] = (int)lrint((180 << SHIFT) / (6. * i));
    }
    for (int64_t i = 0; i < n; i++) {
        int r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
        int v = r > g ? r : g, vmin = r < g ? r : g;
        v = v > b ? v : b;
        vmin = vmin < b ? vmin : b;
        int diff = v - vmin;
        int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
        int s = (diff * sdiv[v] + (1 << (SHIFT - 1))) >> SHIFT;
        int h = (vr & (g - b))
                + (~vr & ((vg & (b - r + 2 * diff))
                          + ((~vg) & (r - g + 4 * diff))));
        h = (h * hdiv[diff] + (1 << (SHIFT - 1))) >> SHIFT;
        h += h < 0 ? 180 : 0;
        dst[3 * i] = (uint8_t)h;
        dst[3 * i + 1] = (uint8_t)s;
        dst[3 * i + 2] = (uint8_t)v;
    }
    return 0;
}

/* (h, w, 3) HSV (hue 0..179, larger hues wrap) -> RGB. */
EXPORT int aug_hsv2rgb(const uint8_t *src, int32_t h, int32_t w,
                       uint8_t *dst) {
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                          {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    int32_t vec_end = w - w % 32;
    for (int64_t i = 0, n = (int64_t)h * w; i < n; i++) {
        int32_t x = (int32_t)(i % w);
        float hh = (float)src[3 * i] * (6.f / 180.f);
        float s = (float)src[3 * i + 1] * (1.f / 255.f);
        float v = (float)src[3 * i + 2] * (1.f / 255.f);
        float rgb[3];
        if (s == 0.f) {
            rgb[0] = rgb[1] = rgb[2] = v;
        } else {
            int sector;
            if (x < vec_end) {
                float pre = truncf(hh);
                hh -= pre;
                float q = truncf(pre * (1.f / 6.f));
                sector = (int)(pre - q * 6.f);
            } else {
                hh = fmodf(hh, 6.f);
                sector = (int)floorf(hh);
                hh -= (float)sector;
                if ((unsigned)sector >= 6u) {
                    sector = 0;
                    hh = 0.f;
                }
            }
            float tab[4] = {v, v * (1.f - s), v * fmaf(-s, hh, 1.f),
                            v * fmaf(-s, 1.f - hh, 1.f)};
            /* sector_data gives (b, g, r) */
            rgb[2] = tab[sector_data[sector][0]];
            rgb[1] = tab[sector_data[sector][1]];
            rgb[0] = tab[sector_data[sector][2]];
        }
        for (int c = 0; c < 3; c++) {
            float t = rgb[c] * 255.f;
            if (x < vec_end) {
                t = truncf(t);
                dst[3 * i + c] = (uint8_t)(t < 0.f ? 0.f : t > 255.f ? 255.f
                                                                      : t);
            } else {
                dst[3 * i + c] = sat_u8(t);
            }
        }
    }
    return 0;
}

/* cv2.borderInterpolate(p, n, BORDER_REFLECT_101). */
static int32_t reflect101(int32_t p, int32_t n) {
    if (n == 1) return 0;
    while (p < 0 || p >= n) p = p < 0 ? -p : 2 * (n - 1) - p;
    return p;
}

/* (h, w, c) -> (h, w, c), k 3 or 5. */
EXPORT int aug_gaussian_blur(const uint8_t *src, int32_t h, int32_t w,
                             int32_t c, int32_t k, uint8_t *dst) {
    static const int32_t k3[3] = {1, 2, 1}, k5[5] = {1, 4, 6, 4, 1};
    if ((k != 3 && k != 5) || h < 1 || w < 1 || c < 1) return -2;
    const int32_t *a = k == 3 ? k3 : k5;
    int32_t r = k / 2, shift = k == 3 ? 4 : 8;
    int64_t row = (int64_t)w * c;
    int32_t *tmp = (int32_t *)malloc(sizeof(int32_t) * (size_t)h * row);
    int32_t *xi = (int32_t *)malloc(sizeof(int32_t) * (size_t)w * k);
    if (!tmp || !xi) {
        free(tmp);
        free(xi);
        return -1;
    }
    for (int32_t x = 0; x < w; x++)
        for (int32_t j = 0; j < k; j++)
            xi[x * k + j] = reflect101(x + j - r, w);
    for (int32_t y = 0; y < h; y++) {
        const uint8_t *s = src + y * row;
        int32_t *t = tmp + y * row;
        for (int32_t x = 0; x < w; x++)
            for (int32_t ch = 0; ch < c; ch++) {
                int32_t acc = 0;
                for (int32_t j = 0; j < k; j++)
                    acc += a[j] * s[(int64_t)xi[x * k + j] * c + ch];
                t[(int64_t)x * c + ch] = acc;
            }
    }
    for (int32_t y = 0; y < h; y++) {
        const int32_t *rows[5];
        for (int32_t j = 0; j < k; j++)
            rows[j] = tmp + reflect101(y + j - r, h) * row;
        uint8_t *o = dst + y * row;
        for (int64_t i = 0; i < row; i++) {
            int32_t acc = 0;
            for (int32_t j = 0; j < k; j++) acc += a[j] * rows[j][i];
            o[i] = (uint8_t)((acc + (1 << (shift - 1))) >> shift);
        }
    }
    free(tmp);
    free(xi);
    return 0;
}
