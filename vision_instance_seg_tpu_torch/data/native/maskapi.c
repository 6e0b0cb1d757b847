/* Native RLE mask codec — C implementation of the hot host-side paths.
 *
 * The PyTorch port's copy of the JAX package's data/native/maskapi.c, the
 * replacement for the pycocotools C extension (_mask.pyx / maskApi.c) that
 * the reference stack uses for polygon->RLE->bitmask and COCO evaluation
 * IoU. Bit-identical semantics to the numpy reference functions in
 * ../rle.py, which the tests hold it against; loaded via ctypes.
 *
 * Conventions: masks are Fortran-order flattened uint8; counts are int64
 * run lengths starting with a run of zeros.
 *
 * Build: python -m vision_instance_seg_tpu_torch.data.native.build (also at
 * first use).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* mask (F-order flat, h*w) -> run counts. Returns number of runs.
 * out must have room for h*w + 1 entries. */
EXPORT int64_t rle_encode(const uint8_t *mask, int64_t n, int64_t *out) {
    if (n == 0) { out[0] = 0; return 1; }
    int64_t nruns = 0;
    uint8_t cur = 0;               /* counts start with a zero run */
    int64_t run = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v == cur) {
            run++;
        } else {
            out[nruns++] = run;
            cur = v;
            run = 1;
        }
    }
    out[nruns++] = run;
    return nruns;
}

/* counts -> mask (F-order flat). Returns 0 on success, -1 if sum != n. */
EXPORT int rle_decode(const int64_t *counts, int64_t m, int64_t n,
                      uint8_t *out) {
    int64_t pos = 0;
    uint8_t v = 0;
    for (int64_t i = 0; i < m; i++) {
        int64_t c = counts[i];
        if (pos + c > n) return -1;
        memset(out + pos, v, (size_t)c);
        pos += c;
        v = 1 - v;
    }
    return pos == n ? 0 : -1;
}

/* counts -> COCO 6-bit varint string. Returns string length.
 * out must have room for m * 13 bytes. */
EXPORT int64_t rle_to_string(const int64_t *counts, int64_t m, char *out) {
    int64_t p = 0;
    for (int64_t i = 0; i < m; i++) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        int more = 1;
        while (more) {
            char c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            out[p++] = c + 48;
        }
    }
    return p;
}

/* COCO varint string -> counts. Returns number of runs (<= slen). */
EXPORT int64_t rle_fr_string(const char *s, int64_t slen, int64_t *out) {
    int64_t m = 0, i = 0;
    while (i < slen) {
        int64_t x = 0;
        int k = 0, more = 1;
        while (more && i < slen) {
            int64_t c = s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            i++; k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (m > 2) x += out[m - 2];
        out[m++] = x;
    }
    return m;
}

EXPORT int64_t rle_area(const int64_t *counts, int64_t m) {
    int64_t a = 0;
    for (int64_t i = 1; i < m; i += 2) a += counts[i];
    return a;
}

/* intersection area of two RLEs over the same h*w grid */
static int64_t rle_intersect_area(const int64_t *a, int64_t ma,
                                  const int64_t *b, int64_t mb) {
    int64_t ia = 0, ib = 0;       /* run indices */
    int64_t ca = ma > 0 ? a[0] : 0, cb = mb > 0 ? b[0] : 0;
    uint8_t va = 0, vb = 0;
    int64_t inter = 0;
    while (ia < ma && ib < mb) {
        int64_t step = ca < cb ? ca : cb;
        if (va && vb) inter += step;
        ca -= step; cb -= step;
        if (ca == 0) { ia++; va = 1 - va; if (ia < ma) ca = a[ia]; }
        if (cb == 0) { ib++; vb = 1 - vb; if (ib < mb) cb = b[ib]; }
    }
    return inter;
}

/* IoU matrix of dt x gt RLEs (variable-length counts, flattened with
 * offsets). iscrowd: per-gt flag -> IoU = I / area(dt). */
EXPORT void rle_iou(const int64_t *dt_counts, const int64_t *dt_offsets,
                    const int64_t *dt_lens, int64_t ndt,
                    const int64_t *gt_counts, const int64_t *gt_offsets,
                    const int64_t *gt_lens, int64_t ngt,
                    const uint8_t *iscrowd, double *out) {
    for (int64_t g = 0; g < ngt; g++) {
        const int64_t *gc = gt_counts + gt_offsets[g];
        int64_t gm = gt_lens[g];
        int64_t garea = rle_area(gc, gm);
        for (int64_t d = 0; d < ndt; d++) {
            const int64_t *dc = dt_counts + dt_offsets[d];
            int64_t dm = dt_lens[d];
            int64_t darea = rle_area(dc, dm);
            int64_t inter = rle_intersect_area(dc, dm, gc, gm);
            double denom = iscrowd[g] ? (double)darea
                                      : (double)(darea + garea - inter);
            out[d * ngt + g] = denom > 0 ? (double)inter / denom : 0.0;
        }
    }
}

/* merge N RLEs (union if intersect=0, intersection if 1) over same grid.
 * counts flattened with offsets; out must hold total+N entries. */
EXPORT int64_t rle_merge(const int64_t *counts, const int64_t *offsets,
                         const int64_t *lens, int64_t n, int64_t hw,
                         int intersect, int64_t *out) {
    /* simple approach: decode-accumulate-encode on a scratch buffer */
    uint8_t *acc = (uint8_t *)malloc((size_t)hw);
    uint8_t *tmp = (uint8_t *)malloc((size_t)hw);
    if (!acc || !tmp) { free(acc); free(tmp); return -1; }
    memset(acc, intersect ? 1 : 0, (size_t)hw);
    for (int64_t i = 0; i < n; i++) {
        if (rle_decode(counts + offsets[i], lens[i], hw, tmp) != 0) {
            free(acc); free(tmp); return -1;
        }
        if (intersect)
            for (int64_t j = 0; j < hw; j++) acc[j] &= tmp[j];
        else
            for (int64_t j = 0; j < hw; j++) acc[j] |= tmp[j];
    }
    int64_t m = rle_encode(acc, hw, out);
    free(acc); free(tmp);
    return m;
}
