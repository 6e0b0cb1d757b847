/* Flood fills for data/imgproc.py: the filled contour of
 * cv2.drawContours(..., thickness=-1) and the seed's 8-connected component
 * of cv2.connectedComponents. Built by build.py with gcc at first use.
 *
 * Every function returns a count or 0 on success, -1 when out of memory
 * and -2 on an input it does not take. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* Sets every cell of value `from` that is connected to `start` (4- or
 * 8-connected, through cells of value `from`) to `to`; `g[start]` must be
 * `from`. Each cell is pushed once, when it is marked, so the stack never
 * holds more than h * w cells. Returns the cells set, or -1. */
static int64_t flood(uint8_t *g, int32_t h, int32_t w, int64_t start,
                     uint8_t from, uint8_t to, int conn8) {
    static const int dy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
    static const int dx[8] = {0, 0, -1, 1, -1, 1, -1, 1};
    int nb = conn8 ? 8 : 4;
    int64_t *stack = (int64_t *)malloc(sizeof(int64_t) * (size_t)h * w);
    if (!stack) return -1;
    int64_t top = 0, n = 0;
    g[start] = to;
    stack[top++] = start;
    while (top) {
        int64_t p = stack[--top];
        int32_t y = (int32_t)(p / w), x = (int32_t)(p % w);
        n++;
        for (int k = 0; k < nb; k++) {
            int32_t ny = y + dy[k], nx = x + dx[k];
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            int64_t q = (int64_t)ny * w + nx;
            if (g[q] == from) {
                g[q] = to;
                stack[top++] = q;
            }
        }
    }
    free(stack);
    return n;
}

/* cv2.drawContours(out, [contour], -1, value, -1) for a contour that
 * find_external_contours traced: `pts` (n, 2) int32 (x, y) inside the
 * (h, w) image, every edge (the closing one too) horizontal, vertical or
 * diagonal, as CHAIN_APPROX_SIMPLE leaves them. Draws the edges' pixels
 * on a grid with a one-pixel frame, floods the 4-connected background
 * from the frame, and sets `value` on every pixel the flood did not
 * reach: the edges, the inside, its holes and what lies in them. */
EXPORT int imgproc_fill_contour(const int32_t *pts, int64_t n, int32_t h,
                                int32_t w, uint8_t *out, uint8_t value) {
    int32_t gh = h + 2, gw = w + 2;
    if (n < 1) return -2;
    uint8_t *g = (uint8_t *)calloc((size_t)gh * gw, 1);
    if (!g) return -1;
    for (int64_t k = 0; k < n; k++) {
        const int32_t *a = pts + 2 * (k ? k - 1 : n - 1), *b = pts + 2 * k;
        int32_t ex = b[0] - a[0], ey = b[1] - a[1];
        int32_t ax = ex < 0 ? -ex : ex, ay = ey < 0 ? -ey : ey;
        int32_t len = ax > ay ? ax : ay;
        if ((ax && ax != len) || (ay && ay != len)) {
            free(g);
            return -2;
        }
        int32_t sx = (ex > 0) - (ex < 0), sy = (ey > 0) - (ey < 0);
        for (int32_t t = 0; t <= len; t++)
            g[(int64_t)(a[1] + t * sy + 1) * gw + a[0] + t * sx + 1] = 1;
    }
    if (flood(g, gh, gw, 0, 0, 2, 0) < 0) {
        free(g);
        return -1;
    }
    for (int32_t y = 0; y < h; y++) {
        const uint8_t *row = g + (int64_t)(y + 1) * gw + 1;
        uint8_t *o = out + (int64_t)y * w;
        for (int32_t x = 0; x < w; x++)
            if (row[x] != 2) o[x] = value;
    }
    free(g);
    return 0;
}

/* The 8-connected component of the nonzero pixels of `mask` (h, w) that
 * holds (x, y), as 1 in `out` (0 elsewhere); empty when that pixel is 0.
 * Returns its size, or -1. */
EXPORT int64_t imgproc_component(const uint8_t *mask, int32_t h, int32_t w,
                                 int32_t x, int32_t y, uint8_t *out) {
    int64_t size = (int64_t)h * w, seed = (int64_t)y * w + x;
    if (!mask[seed]) {
        memset(out, 0, (size_t)size);
        return 0;
    }
    for (int64_t i = 0; i < size; i++) out[i] = mask[i] != 0;
    int64_t n = flood(out, h, w, seed, 1, 2, 1);
    if (n < 0) return -1;
    for (int64_t i = 0; i < size; i++) out[i] = out[i] == 2;
    return n;
}
