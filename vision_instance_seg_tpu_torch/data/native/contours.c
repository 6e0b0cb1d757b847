/* Border following and polygon simplification: what the JAX package's
 * data/polygons.py computes with cv2.findContours(RETR_EXTERNAL,
 * CHAIN_APPROX_SIMPLE), cv2.arcLength and cv2.approxPolyDP, point for
 * point.
 *
 * find_external_contours follows Suzuki and Abe's border following as
 * OpenCV's contour scanner does: the mask binarized and framed by a
 * one-pixel zero border, a raster scan that starts an outer border at a
 * 0 -> 1 transition unless the last border pixel met on the row is marked
 * positive (the blob lies in a hole), 8-connected tracing that marks each
 * border pixel negative when its right neighbour was examined and found 0
 * (else positive), and a point emitted wherever the chain code changes.
 * Contours come out in the order they were found; cv2 lists them newest
 * first, which the Python side does.
 *
 * Build: python -m vision_instance_seg_tpu_torch.data.native.build (also at
 * first use).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

static const int code_dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int code_dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

typedef struct {
    int32_t *pts;            /* x, y pairs */
    int64_t n, cap;
    int32_t *lens;
    int64_t nc, ccap;
    int failed;
} out_t;

static void push_pt(out_t *o, int x, int y) {
    if (o->n == o->cap) {
        int64_t cap = o->cap ? o->cap * 2 : 1024;
        int32_t *p = (int32_t *)realloc(o->pts, (size_t)cap * 2 * sizeof(int32_t));
        if (!p) {
            o->failed = 1;
            return;
        }
        o->pts = p;
        o->cap = cap;
    }
    o->pts[2 * o->n] = x;
    o->pts[2 * o->n + 1] = y;
    o->n++;
}

static void push_len(out_t *o, int32_t len) {
    if (o->nc == o->ccap) {
        int64_t cap = o->ccap ? o->ccap * 2 : 64;
        int32_t *p = (int32_t *)realloc(o->lens, (size_t)cap * sizeof(int32_t));
        if (!p) {
            o->failed = 1;
            return;
        }
        o->lens = p;
        o->ccap = cap;
    }
    o->lens[o->nc++] = len;
}

/* Trace the outer border that starts at i0 (padded coordinates x, y),
 * marking its pixels, and append its CHAIN_APPROX_SIMPLE points. */
static void fetch_contour(int8_t *i0, int step, int x, int y, int8_t nbd,
                          out_t *o) {
    int deltas[16];
    const int base[8] = {1, -step + 1, -step, -step - 1,
                         -1, step - 1, step, step + 1};
    for (int k = 0; k < 16; k++) deltas[k] = base[k & 7];
    int8_t *i1, *i3, *i4 = NULL;
    int s, s_end, prev_s;
    int64_t start = o->n;
    s_end = s = 4;
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (*i1 == 0 && s != s_end);
    if (s == s_end) {                      /* a single pixel */
        *i0 = (int8_t)(nbd | -128);
        push_pt(o, x, y);
    } else {
        i3 = i0;
        prev_s = s ^ 4;
        for (;;) {
            s_end = s;
            while (s < 15) {
                i4 = i3 + deltas[++s];
                if (*i4 != 0) break;
            }
            s &= 7;
            if ((unsigned)(s - 1) < (unsigned)s_end)
                *i3 = (int8_t)(nbd | -128);
            else if (*i3 == 1)
                *i3 = nbd;
            if (s != prev_s) {
                push_pt(o, x, y);
                prev_s = s;
            }
            x += code_dx[s];
            y += code_dy[s];
            if (i4 == i0 && i3 == i1) break;
            i3 = i4;
            s = (s + 4) & 7;
        }
    }
    push_len(o, (int32_t)(o->n - start));
}

/* mask: h x w, nonzero = 1. On return *pts holds the points (x, y in
 * image coordinates) of every external contour in the order found and
 * *lens each contour's point count; free both with contours_free. Returns
 * the number of contours, or -1 when out of memory. */
EXPORT int64_t find_external_contours(const uint8_t *mask, int32_t h,
                                      int32_t w, int32_t **pts,
                                      int32_t **lens) {
    int step = w + 2, rows = h + 2;
    int8_t *img = (int8_t *)calloc((size_t)step * rows, 1);
    out_t o = {NULL, 0, 0, NULL, 0, 0, 0};
    *pts = NULL;
    *lens = NULL;
    if (!img) return -1;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            img[(int64_t)(y + 1) * step + x + 1] =
                mask[(int64_t)y * w + x] ? 1 : 0;
    int width = step - 1, height = rows - 1;
    int nbd = 2;
    for (int y = 1; y < height && !o.failed; y++) {
        int8_t *row = img + (int64_t)y * step;
        int lnbd_x = 0, prev = 0;
        for (int x = 1; x < width; x++) {
            int p;
            for (; x < width && (p = row[x]) == prev; x++)
                ;
            if (x >= width) break;
            int is_hole = 0;
            if (!(prev == 0 && p == 1)) {
                if (p != 0 || prev < 1) goto resume;
                if (prev & -2) lnbd_x = x - 1;
                is_hole = 1;
            }
            if (is_hole || row[lnbd_x] > 0) goto resume;
            fetch_contour(row + x, step, x - 1, y - 1, (int8_t)nbd, &o);
            nbd = (nbd + 1) & 127;
            nbd += nbd == 0 ? 3 : 0;
            /* the scan resumes after the start pixel, now marked */
            prev = row[x];
            continue;
        resume:
            prev = p;
            if (prev & -2) lnbd_x = x;
        }
    }
    free(img);
    if (o.failed) {
        free(o.pts);
        free(o.lens);
        return -1;
    }
    *pts = o.pts;
    *lens = o.lens;
    return o.nc;
}

EXPORT void contours_free(void *p) { free(p); }

/* cv2.arcLength(closed=True) of integer points: float32 steps summed in
 * double. */
EXPORT double arc_length(const int32_t *pts, int64_t n) {
    if (n <= 1) return 0.0;
    double perimeter = 0.0;
    float px = (float)pts[2 * (n - 1)], py = (float)pts[2 * (n - 1) + 1];
    for (int64_t i = 0; i < n; i++) {
        float x = (float)pts[2 * i], y = (float)pts[2 * i + 1];
        float dx = x - px, dy = y - py;
        perimeter += sqrtf(dx * dx + dy * dy);
        px = x;
        py = y;
    }
    return perimeter;
}

typedef struct {
    int64_t start, end;
} range_t;

/* cv2.approxPolyDP(closed=True) (approx.cpp approxPolyDP_) on integer
 * points: the start found by three farthest-point passes, the
 * Douglas-Peucker stack over each point's distance to the segment (so a
 * spike that doubles back keeps its tip), and the final clean-up of
 * near-collinear points. dst needs n entries; returns the count written,
 * or -1 when out of memory. */
EXPORT int64_t approx_poly_dp(const int32_t *src, int64_t count, double eps,
                              int32_t *dst) {
    range_t slice = {0, 0}, right_slice = {0, 0};
    int64_t sx = 0, sy = 0, ex = 0, ey = 0, px = 0, py = 0;
    int64_t i, j, pos = 0, wpos, new_count = 0;
    int le_eps = 0;
    int64_t top = 0, stacksz = count + 8;
    if (count == 0) return 0;
    range_t *stack = (range_t *)malloc(sizeof(range_t) * stacksz);
    if (!stack) return -1;
#define READ_PT(X, Y, P) \
    do { X = src[2 * (P)]; Y = src[2 * (P) + 1]; if (++(P) >= count) (P) = 0; } while (0)
#define READ_DST_PT(X, Y, P) \
    do { X = dst[2 * (P)]; Y = dst[2 * (P) + 1]; if (++(P) >= count) (P) = 0; } while (0)
#define WRITE_PT(X, Y) \
    do { dst[2 * new_count] = (int32_t)(X); dst[2 * new_count + 1] = (int32_t)(Y); new_count++; } while (0)
#define PUSH(R) \
    do { if (top >= stacksz) { stacksz = stacksz * 3 / 2; \
         range_t *grown = (range_t *)realloc(stack, sizeof(range_t) * stacksz); \
         if (!grown) { free(stack); return -1; } stack = grown; } \
         stack[top++] = (R); } while (0)

    eps *= eps;
    /* 1. two points approximately farthest apart */
    for (i = 0; i < 3; i++) {
        double dist, max_dist = 0;
        pos = (pos + right_slice.start) % count;
        READ_PT(sx, sy, pos);
        for (j = 1; j < count; j++) {
            double dx, dy;
            READ_PT(px, py, pos);
            dx = (double)(px - sx);
            dy = (double)(py - sy);
            dist = dx * dx + dy * dy;
            if (dist > max_dist) {
                max_dist = dist;
                right_slice.start = j;
            }
        }
        le_eps = max_dist <= eps;
    }
    /* 2. the stack */
    if (!le_eps) {
        right_slice.end = slice.start = pos % count;
        slice.end = right_slice.start =
            (right_slice.start + slice.start) % count;
        PUSH(right_slice);
        PUSH(slice);
    } else {
        WRITE_PT(sx, sy);
    }
    /* 3. split each slice at its farthest point until it is within eps */
    while (top > 0) {
        slice = stack[--top];
        ex = src[2 * slice.end];
        ey = src[2 * slice.end + 1];
        pos = slice.start;
        READ_PT(sx, sy, pos);
        if (pos != slice.end) {
            double dx, dy, dist, max_dist = 0, len2;
            dx = (double)(ex - sx);
            dy = (double)(ey - sy);
            len2 = dx * dx + dy * dy;
            while (pos != slice.end) {
                READ_PT(px, py, pos);
                /* squared distance to the segment (an endpoint when the
                 * point projects outside it) */
                double ux = (double)(px - sx), uy = (double)(py - sy);
                double t = ux * dx + uy * dy;
                if (t <= 0) {
                    dist = ux * ux + uy * uy;
                } else if (t >= len2) {
                    double vx = (double)(px - ex), vy = (double)(py - ey);
                    dist = vx * vx + vy * vy;
                } else {
                    double cr = uy * dx - ux * dy;
                    dist = cr * cr / len2;
                }
                if (dist > max_dist) {
                    max_dist = dist;
                    right_slice.start = (pos + count - 1) % count;
                }
            }
            le_eps = max_dist <= eps;
        } else {
            le_eps = 1;
            sx = src[2 * slice.start];
            sy = src[2 * slice.start + 1];
        }
        if (le_eps) {
            WRITE_PT(sx, sy);
        } else {
            right_slice.end = slice.end;
            slice.end = right_slice.start;
            PUSH(right_slice);
            PUSH(slice);
        }
    }
    free(stack);
    /* 4. drop points on near-straight runs, in place */
    count = new_count;
    pos = count - 1;
    READ_DST_PT(sx, sy, pos);
    wpos = pos;
    READ_DST_PT(px, py, pos);
    for (i = 0; i < count && new_count > 2; i++) {
        double dx, dy, dist, inner;
        READ_DST_PT(ex, ey, pos);
        dx = (double)(ex - sx);
        dy = (double)(ey - sy);
        dist = fabs((double)(px - sx) * dy - (double)(py - sy) * dx);
        inner = (double)((px - sx) * (ex - px) + (py - sy) * (ey - py));
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) && dx != 0
            && dy != 0 && inner >= 0) {
            new_count--;
            sx = ex;
            sy = ey;
            dst[2 * wpos] = (int32_t)sx;
            dst[2 * wpos + 1] = (int32_t)sy;
            if (++wpos >= count) wpos = 0;
            READ_DST_PT(px, py, pos);
            i++;
            continue;
        }
        sx = px;
        sy = py;
        dst[2 * wpos] = (int32_t)sx;
        dst[2 * wpos + 1] = (int32_t)sy;
        if (++wpos >= count) wpos = 0;
        px = ex;
        py = ey;
    }
#undef READ_PT
#undef READ_DST_PT
#undef WRITE_PT
#undef PUSH
    return new_count;
}
