/* JPEG decoder and baseline encoder, the port's replacement for PIL's
 * (libjpeg-turbo's) decode and cv2.imwrite's encode.
 *
 * Decoder: sequential (SOF0 / SOF1) and progressive (SOF2) Huffman JPEG
 * and sequential (SOF9) and progressive (SOF10) arithmetic-coded JPEG,
 * with 8-bit samples, one or more scans, restart intervals, 1, 3 or 4
 * components, each sampled at any integral fraction of the largest
 * factor (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 3 x 1, ...). Progressive
 * scans (DC first and refine, AC first and refine with spectral
 * selection, successive approximation and, in Huffman files, EOB runs)
 * add into a coefficient buffer that the IDCT reads once every scan is
 * in; libjpeg smooths blocks only where coefficients are still
 * incomplete, which no whole file leaves. The arithmetic decoder is
 * jdarith.c's QM coder: the statistics bins of each DC and AC table, the
 * DAC marker's conditioning (L, U and Kx; by default 0, 1 and 5) and
 * restart intervals, which reset the coder and its statistics. It
 * computes what libjpeg's default decompression computes, byte for byte:
 *   - the accurate integer IDCT (jidctint.c, jpeg_idct_islow) with its
 *     10-bit range-limit table;
 *   - upsampling as jdsample.c's jinit_upsampler picks it per component:
 *     full size; "fancy" triangular h2v1, h1v2 and h2v2 (box replication
 *     below 3 chroma columns for h2v1 and h2v2), edges replicated from the
 *     last real sample row and column; any other integral ratio replicated
 *     (int_upsample);
 *   - 3 components: YCbCr through the fixed-point YCbCr -> RGB tables
 *     (jdcolor.c), or RGB copied (rgb_rgb_convert) where libjpeg's
 *     default_decompress_parms reads RGB: no JFIF marker, and an Adobe
 *     marker of transform 0, or no Adobe marker and component ids 'R',
 *     'G', 'B' (an Adobe transform other than 0 is YCbCr);
 *   - grey replicated to RGB; no EXIF orientation applied;
 *   - 4 components: CMYK, or YCCK under an Adobe transform other than 0
 *     (jdcolor.c ycck_cmyk_convert), to RGB as PIL reads them (inverted,
 *     "CMYK;I", then cmyk2rgb: nk - nk * C / 255 with nk = 255 - K) or,
 *     under cmyk_cv2, as cv2.imread does (K - ((255 - C) * K >> 8) on
 *     libjpeg's CMYK).
 * Lossless or hierarchical, 12-bit and 2-component files, and sampling
 * factors that do not divide the largest (which libjpeg refuses too,
 * JERR_FRACT_SAMPLE_NOTIMPL), are reported by jpeg_info's status and not
 * decoded.
 *
 * Encoder: baseline RGB at 4:2:0 or 4:4:4 with libjpeg's defaults: the
 * Annex K quantization tables scaled by its quality rule, the Annex K
 * Huffman tables, the fixed-point RGB -> YCbCr tables, h2v2 downsampling
 * with its alternating bias, edge replication of partial MCUs, the
 * accurate integer forward DCT and rounding quantization (jccolor.c,
 * jcsample.c, jcprepct.c, jccoefct.c, jfdctint.c, jcdctmgr.c): the file
 * cv2.imwrite writes.
 *
 * Build: python -m vision_instance_seg_tpu_torch.data.native.build (also at
 * first use).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* jpeg_info status (>= 0; jpeg.py names them) */
enum { JS_OK = 0, JS_LOSSLESS = 3, JS_PRECISION, JS_COMPONENTS,
       JS_SAMPLING = 7 };
/* errors (< 0) */
enum { JE_TRUNCATED = -1, JE_HUFFMAN = -3, JE_TABLE = -4, JE_NOFRAME = -5,
       JE_MEMORY = -6, JE_FORMAT = -7, JE_BUFFER = -8 };

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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

/* ------------------------------------------------------------- decoder */

typedef struct {
    uint16_t lookup[65536];  /* 16 peeked bits -> (length << 8) | value */
    int defined;
} huff_t;

typedef struct {
    int id, h, v, tq, td, ta;
    int bw, bh;              /* blocks in the MCU-padded plane */
    int wib, hib;            /* blocks the component's own size needs */
    int dw, dh;              /* downsampled width and height */
    int pred, latched;
    int dc_context;          /* arithmetic DC conditioning category */
    int q[64];               /* latched quantization table, natural order */
    int16_t *coef;           /* bh * bw * 64, natural order */
} comp_t;

typedef struct {
    const uint8_t *data;
    int64_t n, pos;
    uint64_t acc;
    int nbits;
    int marker_hit;
    int64_t marker_pos;
} bits_t;

/* The QM coder's state (jdarith.c arith_entropy_decoder). */
typedef struct {
    const uint8_t *data;
    int64_t n, pos;
    int marker_hit;
    int64_t marker_pos;
    int64_t c, a;
    int ct;                      /* -16 at a (re)start, -1 after an error */
} arith_t;

#define NUM_ARITH_TBLS 16
#define DC_STAT_BINS 64
#define AC_STAT_BINS 256

typedef struct {
    int width, height, ncomp, frame, progressive, arith;
    int saw_jfif, saw_adobe, adobe_transform, restart_interval, max_h, max_v;
    int scans;                   /* SOS markers read */
    int rgb, ycck;               /* the colour space, fixed at the first SOS */
    int eobrun;                  /* progressive AC scans' end-of-band run */
    int mcux, mcuy;
    int qt[4][64];
    int qt_defined[4];
    huff_t *dc[4], *ac[4];
    comp_t comp[4];
    uint8_t dc_L[NUM_ARITH_TBLS], dc_U[NUM_ARITH_TBLS], ac_K[NUM_ARITH_TBLS];
    uint8_t dc_stats[NUM_ARITH_TBLS][DC_STAT_BINS];
    uint8_t ac_stats[NUM_ARITH_TBLS][AC_STAT_BINS];
    uint8_t fixed_bin;
} dec_t;

static void br_fill(bits_t *b) {
    while (b->nbits <= 56) {
        uint32_t c = 0;
        if (!b->marker_hit && b->pos < b->n) {
            c = b->data[b->pos];
            if (c == 0xFF) {
                int64_t p = b->pos + 1;
                while (p < b->n && b->data[p] == 0xFF) p++;
                if (p < b->n && b->data[p] == 0x00) {
                    b->pos = p + 1;
                } else {
                    b->marker_hit = 1;
                    b->marker_pos = p - 1;
                    c = 0;
                }
            } else {
                b->pos++;
            }
        }
        b->acc = (b->acc << 8) | c;
        b->nbits += 8;
    }
}

static inline int br_get(bits_t *b, int n) {
    if (n == 0) return 0;
    if (b->nbits < n) br_fill(b);
    int v = (int)((b->acc >> (b->nbits - n)) & ((1u << n) - 1));
    b->nbits -= n;
    return v;
}

static inline int huff_decode(bits_t *b, const huff_t *h) {
    if (b->nbits < 16) br_fill(b);
    uint32_t peek = (uint32_t)(b->acc >> (b->nbits - 16)) & 0xFFFF;
    uint16_t e = h->lookup[peek];
    int len = e >> 8;
    if (len == 0) return -1;
    b->nbits -= len;
    return e & 0xFF;
}

static inline int extend(int v, int s) {
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

/* Position of the next marker's 0xFF at or after p (fill bytes skipped),
 * or n. */
static int64_t next_marker(const uint8_t *d, int64_t n, int64_t p) {
    for (; p + 1 < n; p++) {
        if (d[p] != 0xFF) continue;
        int64_t q = p + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] != 0x00) return q - 1;
        p = q;
    }
    return n;
}

/* Move the bits or bytes of a scan past the restart marker where the
 * last interval ended; a marker that is not RSTn (or the end of the data)
 * is left in place and the rest of the scan reads zeros. */
static int64_t skip_restart(const uint8_t *data, int64_t n, int marker_hit,
                            int64_t marker_pos, int64_t pos, int *hit) {
    int64_t m = marker_hit ? marker_pos : next_marker(data, n, pos);
    if (m + 1 < n && data[m + 1] >= 0xD0 && data[m + 1] <= 0xD7) {
        *hit = 0;
        return m + 2;
    }
    *hit = 1;
    return m;
}

/* Drop the bits left before a restart marker and resume after it. */
static void br_restart(bits_t *b) {
    b->acc = 0;
    b->nbits = 0;
    b->pos = skip_restart(b->data, b->n, b->marker_hit, b->marker_pos,
                          b->pos, &b->marker_hit);
    b->marker_pos = b->pos;
}

static int build_huff(huff_t *h, const uint8_t *counts, const uint8_t *vals,
                      int nvals) {
    memset(h->lookup, 0, sizeof(h->lookup));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < counts[len - 1]; i++) {
            if (k >= nvals || code >= (1 << len)) return JE_TABLE;
            int lo = code << (16 - len), hi = (code + 1) << (16 - len);
            uint16_t e = (uint16_t)((len << 8) | vals[k]);
            for (int j = lo; j < hi; j++) h->lookup[j] = e;
            code++;
            k++;
        }
        code <<= 1;
    }
    h->defined = 1;
    return 0;
}

static int decode_block(dec_t *d, bits_t *b, comp_t *c, int16_t *blk) {
    const huff_t *dc = d->dc[c->td], *ac = d->ac[c->ta];
    int s = huff_decode(b, dc);
    if (s < 0 || s > 16) return JE_HUFFMAN;
    int diff = extend(br_get(b, s), s);
    c->pred += diff;
    blk[0] = (int16_t)c->pred;
    for (int k = 1; k < 64; k++) {
        int rs = huff_decode(b, ac);
        if (rs < 0) return JE_HUFFMAN;
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) return JE_HUFFMAN;
            blk[natural_order[k]] = (int16_t)extend(br_get(b, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    return 0;
}

/* One block of a progressive scan over coefficients ss..se at bit al
 * (jdphuff.c decode_mcu_DC_first / DC_refine / AC_first / AC_refine);
 * natural_order's 16 padding entries catch runs past 63, as libjpeg's. */
static int decode_block_prog(dec_t *d, bits_t *b, comp_t *c, int16_t *blk,
                             int ss, int se, int ah, int al) {
    if (ss == 0) {
        if (ah) {
            if (br_get(b, 1)) blk[0] |= (int16_t)(1 << al);
            return 0;
        }
        int s = huff_decode(b, d->dc[c->td]);
        if (s < 0 || s > 16) return JE_HUFFMAN;
        c->pred += extend(br_get(b, s), s);
        blk[0] = (int16_t)((unsigned)c->pred << al);
        return 0;
    }
    const huff_t *ac = d->ac[c->ta];
    int k = ss;
    if (!ah) {
        if (d->eobrun > 0) {
            d->eobrun--;
            return 0;
        }
        for (; k <= se; k++) {
            int rs = huff_decode(b, ac);
            if (rs < 0) return JE_HUFFMAN;
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[natural_order[k]] =
                    (int16_t)((unsigned)extend(br_get(b, s), s) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                d->eobrun = 1 << r;
                if (r) d->eobrun += br_get(b, r);
                d->eobrun--;
                break;
            }
        }
        return 0;
    }
    int p1 = 1 << al, m1 = -1 * (1 << al);
    if (d->eobrun == 0) {
        for (; k <= se; k++) {
            int rs = huff_decode(b, ac);
            if (rs < 0) return JE_HUFFMAN;
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = br_get(b, 1) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += br_get(b, r);
                break;
            }
            do {
                int16_t *coef = blk + natural_order[k];
                if (*coef != 0) {
                    if (br_get(b, 1) && (*coef & p1) == 0)
                        *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *coef = blk + natural_order[k];
            if (*coef != 0 && br_get(b, 1) && (*coef & p1) == 0)
                *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
        }
        d->eobrun--;
    }
    return 0;
}

/* ------------------------------------------------ arithmetic decoding */

/* jaricom.c jpeg_aritab (ITU-T T.81 Table D.2): Qe_Value << 16 |
 * Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry
 * is the fixed probability 0.5 (T.851) that signs and DC refinements use. */
#define V(i, qe, nl, nm, sw) \
    (((int64_t)(qe) << 16) | ((int64_t)(nm) << 8) | ((sw) << 7) | (nl))
static const int64_t aritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

/* The next byte of entropy-coded data (jdarith.c get_byte and its
 * marker rule): a stuffed 0xFF 0x00 reads 0xFF; at a marker (or the end
 * of the data) the coder is fed zeros until the scan is done. */
static int ar_byte(arith_t *e) {
    if (e->marker_hit) return 0;
    if (e->pos >= e->n) {
        e->marker_hit = 1;
        e->marker_pos = e->n;
        return 0;
    }
    int v = e->data[e->pos++];
    if (v != 0xFF) return v;
    int64_t p = e->pos;
    while (p < e->n && e->data[p] == 0xFF) p++;
    if (p < e->n && e->data[p] == 0x00) {
        e->pos = p + 1;
        return 0xFF;
    }
    e->marker_hit = 1;
    e->marker_pos = p - 1;
    return 0;
}

/* jdarith.c arith_decode: one binary decision from statistics bin st. */
static int ar_decode(arith_t *e, uint8_t *st) {
    while (e->a < 0x8000) {            /* renormalization, D.2.6 */
        if (--e->ct < 0) {
            e->c = (e->c << 8) | ar_byte(e);
            if ((e->ct += 8) < 0)        /* the two initial bytes */
                if (++e->ct == 0) e->a = 0x8000;
        }
        e->a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = e->a - qe;          /* D.2.4 and D.2.5 */
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {                 /* conditional LPS exchange */
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {                 /* conditional MPS exchange */
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* A DC difference (F.19, F.21-F.24); updates the component's
 * conditioning category. Returns 0, or -1 on a magnitude overflow. */
static int ar_dc_diff(dec_t *d, arith_t *e, comp_t *c, int *diff) {
    uint8_t *base = d->dc_stats[c->td];
    uint8_t *st = base + c->dc_context;
    if (ar_decode(e, st) == 0) {
        c->dc_context = 0;
        *diff = 0;
        return 0;
    }
    int sign = ar_decode(e, st + 1);
    st += 2 + sign;
    int m = ar_decode(e, st);
    if (m) {
        st = base + 20;                    /* X1 */
        while (ar_decode(e, st)) {
            if ((m <<= 1) == 0x8000) return -1;
            st++;
        }
    }
    if (m < (int)((1L << d->dc_L[c->td]) >> 1))
        c->dc_context = 0;
    else if (m > (int)((1L << d->dc_U[c->td]) >> 1))
        c->dc_context = 12 + sign * 4;
    else
        c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (ar_decode(e, st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return 0;
}

/* AC coefficients ss..se of one block, first pass (F.20-F.24), each
 * shifted up by al. Returns 0, or -1 on a spectral or magnitude
 * overflow. */
static int ar_ac_first(dec_t *d, arith_t *e, comp_t *c, int16_t *blk,
                       int ss, int se, int al) {
    uint8_t *base = d->ac_stats[c->ta];
    for (int k = ss; k <= se; k++) {
        uint8_t *st = base + 3 * (k - 1);
        if (ar_decode(e, st)) break;        /* EOB */
        while (ar_decode(e, st + 1) == 0) {
            st += 3;
            if (++k > se) return -1;
        }
        int sign = ar_decode(e, &d->fixed_bin);
        st += 2;
        int m = ar_decode(e, st);
        if (m && ar_decode(e, st)) {
            m <<= 1;
            st = base + (k <= d->ac_K[c->ta] ? 189 : 217);
            while (ar_decode(e, st)) {
                if ((m <<= 1) == 0x8000) return -1;
                st++;
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ar_decode(e, st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[natural_order[k]] = (int16_t)((unsigned)v << al);
    }
    return 0;
}

/* AC refinement of one block (jdarith.c decode_mcu_AC_refine). */
static int ar_ac_refine(dec_t *d, arith_t *e, comp_t *c, int16_t *blk,
                        int ss, int se, int al) {
    uint8_t *base = d->ac_stats[c->ta];
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex;
    for (kex = se; kex > 0; kex--)        /* the previous stage's EOB */
        if (blk[natural_order[kex]]) break;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = base + 3 * (k - 1);
        if (k > kex && ar_decode(e, st)) break;
        for (;;) {
            int16_t *coef = blk + natural_order[k];
            if (*coef) {
                if (ar_decode(e, st + 2))
                    *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                break;
            }
            if (ar_decode(e, st + 1)) {
                *coef = (int16_t)(ar_decode(e, &d->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > se) return -1;
        }
    }
    return 0;
}

/* One block of an arithmetic-coded scan: sequential (DC and AC 1-63) or
 * one progressive pass. An error sets ct to -1, after which libjpeg
 * leaves the scan's remaining blocks as they are; so does this. */
static void ar_block(dec_t *d, arith_t *e, comp_t *c, int16_t *blk, int ss,
                     int se, int ah, int al) {
    if (d->progressive && ss == 0 && ah) {  /* DC refine: no error check */
        if (ar_decode(e, &d->fixed_bin)) blk[0] |= (int16_t)(1 << al);
        return;
    }
    if (e->ct == -1) return;
    int r = 0;
    if (!d->progressive || ss == 0) {
        int diff;
        r = ar_dc_diff(d, e, c, &diff);
        if (!r) {
            c->pred = (c->pred + diff) & 0xFFFF;
            blk[0] = (int16_t)(d->progressive ? (unsigned)c->pred << al
                                              : (unsigned)c->pred);
        }
        if (!r && !d->progressive) r = ar_ac_first(d, e, c, blk, 1, 63, 0);
    } else if (!ah) {
        r = ar_ac_first(d, e, c, blk, ss, se, al);
    } else {
        r = ar_ac_refine(d, e, c, blk, ss, se, al);
    }
    if (r) e->ct = -1;
}

/* Zero the statistics a scan uses and restart the coder (jdarith.c
 * start_pass and process_restart). */
static void ar_reset(dec_t *d, arith_t *e, int ns, comp_t **sc, int ss,
                     int ah) {
    for (int i = 0; i < ns; i++) {
        if (!d->progressive || (ss == 0 && ah == 0)) {
            memset(d->dc_stats[sc[i]->td], 0, DC_STAT_BINS);
            sc[i]->pred = 0;
            sc[i]->dc_context = 0;
        }
        if (!d->progressive || ss)
            memset(d->ac_stats[sc[i]->ta], 0, AC_STAT_BINS);
    }
    e->c = 0;
    e->a = 0;
    e->ct = -16;
}

static int decode_scan(dec_t *d, const uint8_t *data, int64_t n,
                       int64_t pos, int ns, comp_t **sc, int ss, int se,
                       int ah, int al, int64_t *end) {
    bits_t b = {data, n, pos, 0, 0, 0, 0};
    arith_t e = {data, n, pos, 0, 0, 0, 0, 0};
    /* a progressive scan needs the DC tables (DC first), the AC table
     * (AC scans) or none (DC refine) */
    int need_dc = !d->progressive || (ss == 0 && ah == 0);
    int need_ac = !d->progressive || ss > 0;
    d->eobrun = 0;
    for (int i = 0; i < ns; i++) {
        comp_t *c = sc[i];
        if (!d->arith
            && ((need_dc && (!d->dc[c->td] || !d->dc[c->td]->defined))
                || (need_ac && (!d->ac[c->ta] || !d->ac[c->ta]->defined))))
            return JE_TABLE;
        if (!c->latched) {
            if (!d->qt_defined[c->tq]) return JE_TABLE;
            memcpy(c->q, d->qt[c->tq], sizeof(c->q));
            c->latched = 1;
        }
        c->pred = 0;
    }
    if (d->arith) ar_reset(d, &e, ns, sc, ss, ah);
    int mcux, mcuy;
    if (ns == 1) {
        mcux = sc[0]->wib;
        mcuy = sc[0]->hib;
    } else {
        mcux = d->mcux;
        mcuy = d->mcuy;
    }
    int64_t done = 0;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++, done++) {
            if (d->restart_interval && done
                && done % d->restart_interval == 0) {
                if (d->arith) {
                    e.pos = skip_restart(data, n, e.marker_hit, e.marker_pos,
                                         e.pos, &e.marker_hit);
                    e.marker_pos = e.pos;
                    ar_reset(d, &e, ns, sc, ss, ah);
                } else {
                    br_restart(&b);
                    for (int i = 0; i < ns; i++) sc[i]->pred = 0;
                    d->eobrun = 0;
                }
            }
            for (int i = 0; i < ns; i++) {
                comp_t *c = sc[i];
                int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
                for (int y = 0; y < bh; y++) {
                    for (int x = 0; x < bwn; x++) {
                        int row = ns == 1 ? my : my * c->v + y;
                        int col = ns == 1 ? mx : mx * c->h + x;
                        int16_t *blk = c->coef
                            + ((int64_t)row * c->bw + col) * 64;
                        int r = 0;
                        if (!d->progressive)
                            memset(blk, 0, 64 * sizeof(int16_t));
                        if (d->arith)
                            ar_block(d, &e, c, blk, ss, se, ah, al);
                        else if (d->progressive)
                            r = decode_block_prog(d, &b, c, blk, ss, se, ah,
                                                  al);
                        else
                            r = decode_block(d, &b, c, blk);
                        if (r) return r;
                    }
                }
            }
        }
    }
    if (d->arith)
        *end = e.marker_hit ? e.marker_pos : next_marker(data, n, e.pos);
    else
        *end = b.marker_hit ? b.marker_pos : next_marker(data, n, b.pos);
    return 0;
}

/* jidctint.c jpeg_idct_islow: dequantize, two 1-D passes, range limit. */
static void idct_islow(const int16_t *in, const int *q, uint8_t *out,
                       int stride, const uint8_t *range_limit) {
    int ws[64];
    int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    int64_t z1, z2, z3, z4, z5;
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const int *qp = q + c;
        int *wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0
            && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        z2 = ip[16] * qp[16];
        z3 = ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
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
    for (int r = 0; r < 8; r++) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + (int64_t)r * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0
            && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t v = range_limit[(int)DESCALE((int64_t)wp[0],
                                                 PASS1_BITS + 3) & 1023];
            for (int i = 0; i < 8; i++) op[i] = v;
            continue;
        }
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
        tmp1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
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
#define OUT(x) range_limit[(int)DESCALE(x, CONST_BITS + PASS1_BITS + 3) & 1023]
        op[0] = OUT(tmp10 + tmp3);
        op[7] = OUT(tmp10 - tmp3);
        op[1] = OUT(tmp11 + tmp2);
        op[6] = OUT(tmp11 - tmp2);
        op[2] = OUT(tmp12 + tmp1);
        op[5] = OUT(tmp12 - tmp1);
        op[3] = OUT(tmp13 + tmp0);
        op[4] = OUT(tmp13 - tmp0);
#undef OUT
    }
}

static int parse(dec_t *d, const uint8_t *data, int64_t n, int decode) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return JE_FORMAT;
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {    /* jdmarker.c get_soi */
        d->dc_L[t] = 0;
        d->dc_U[t] = 1;
        d->ac_K[t] = 5;
    }
    d->fixed_bin = 113;
    int64_t p = 2;
    for (;;) {
        p = next_marker(data, n, p);
        if (p + 1 >= n) return decode ? JE_TRUNCATED : JE_NOFRAME;
        int m = data[p + 1];
        p += 2;
        if (m == 0xD9) return d->frame ? 0 : JE_NOFRAME;   /* EOI */
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (p + 2 > n) return JE_TRUNCATED;
        int len = (data[p] << 8) | data[p + 1];
        if (len < 2 || p + len > n) return JE_TRUNCATED;
        const uint8_t *s = data + p + 2;
        int sl = len - 2;
        if (m == 0xE0 && sl >= 14 && !memcmp(s, "JFIF\0", 5)) {
            d->saw_jfif = 1;
        } else if (m == 0xEE && sl >= 12 && !memcmp(s, "Adobe", 5)) {
            d->saw_adobe = 1;
            d->adobe_transform = s[11];
        } else if (m == 0xDB) {                               /* DQT */
            int i = 0;
            while (i < sl) {
                int pq = s[i] >> 4, tq = s[i] & 15;
                if (tq > 3) return JE_TABLE;
                i++;
                for (int k = 0; k < 64; k++) {
                    int v;
                    if (pq) {
                        if (i + 1 >= sl) return JE_TRUNCATED;
                        v = (s[i] << 8) | s[i + 1];
                        i += 2;
                    } else {
                        if (i >= sl) return JE_TRUNCATED;
                        v = s[i++];
                    }
                    d->qt[tq][natural_order[k]] = v;
                }
                d->qt_defined[tq] = 1;
            }
        } else if (m == 0xC4) {                               /* DHT */
            int i = 0;
            while (i + 17 <= sl) {
                int tc = s[i] >> 4, th = s[i] & 15;
                if (th > 3 || tc > 1) return JE_TABLE;
                const uint8_t *counts = s + i + 1;
                int nv = 0;
                for (int k = 0; k < 16; k++) nv += counts[k];
                if (nv > 256 || i + 17 + nv > sl) return JE_TABLE;
                if (decode) {
                    huff_t **slot = tc ? &d->ac[th] : &d->dc[th];
                    if (!*slot) *slot = (huff_t *)malloc(sizeof(huff_t));
                    if (!*slot) return JE_MEMORY;
                    int r = build_huff(*slot, counts, s + i + 17, nv);
                    if (r) return r;
                }
                i += 17 + nv;
            }
        } else if (m == 0xCC) {                               /* DAC */
            for (int i = 0; i + 1 < sl; i += 2) {
                int t = s[i], v = s[i + 1];
                if (t >= 2 * NUM_ARITH_TBLS) return JE_TABLE;
                if (t >= NUM_ARITH_TBLS) {
                    d->ac_K[t - NUM_ARITH_TBLS] = (uint8_t)v;
                } else {
                    d->dc_L[t] = (uint8_t)(v & 15);
                    d->dc_U[t] = (uint8_t)(v >> 4);
                    if (d->dc_L[t] > d->dc_U[t]) return JE_TABLE;
                }
            }
        } else if (m == 0xDD) {                               /* DRI */
            if (sl < 2) return JE_TRUNCATED;
            d->restart_interval = (s[0] << 8) | s[1];
        } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8
                   && m != 0xCC) {                            /* SOFn */
            /* SOF0, 1, 2 (Huffman), SOF9, 10 (arithmetic); the rest are
             * lossless or hierarchical */
            if (m != 0xC0 && m != 0xC1 && m != 0xC2 && m != 0xC9
                && m != 0xCA)
                return JS_LOSSLESS;
            d->progressive = m == 0xC2 || m == 0xCA;
            d->arith = m >= 0xC9;
            if (sl < 6) return JE_TRUNCATED;
            if (s[0] != 8) return JS_PRECISION;
            d->height = (s[1] << 8) | s[2];
            d->width = (s[3] << 8) | s[4];
            d->ncomp = s[5];
            if (d->width == 0 || d->height == 0) return JE_FORMAT;
            if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4)
                return JS_COMPONENTS;
            if (sl < 6 + 3 * d->ncomp) return JE_TRUNCATED;
            d->max_h = d->max_v = 1;
            for (int c = 0; c < d->ncomp; c++) {
                comp_t *cp = &d->comp[c];
                cp->id = s[6 + 3 * c];
                cp->h = s[7 + 3 * c] >> 4;
                cp->v = s[7 + 3 * c] & 15;
                cp->tq = s[8 + 3 * c];
                if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4
                    || cp->tq > 3)
                    return JE_FORMAT;
                if (cp->h > d->max_h) d->max_h = cp->h;
                if (cp->v > d->max_v) d->max_v = cp->v;
            }
            d->frame = 1;
            /* jdsample.c: a factor that does not divide the largest is
             * JERR_FRACT_SAMPLE_NOTIMPL */
            for (int c = 0; c < d->ncomp; c++)
                if (d->max_h % d->comp[c].h || d->max_v % d->comp[c].v)
                    return JS_SAMPLING;
            d->mcux = (d->width + 8 * d->max_h - 1) / (8 * d->max_h);
            d->mcuy = (d->height + 8 * d->max_v - 1) / (8 * d->max_v);
            for (int c = 0; c < d->ncomp; c++) {
                comp_t *cp = &d->comp[c];
                int64_t cw = ((int64_t)d->width * cp->h + d->max_h - 1)
                             / d->max_h;
                int64_t ch = ((int64_t)d->height * cp->v + d->max_v - 1)
                             / d->max_v;
                cp->dw = (int)cw;
                cp->dh = (int)ch;
                cp->wib = (int)((cw + 7) / 8);
                cp->hib = (int)((ch + 7) / 8);
                cp->bw = d->ncomp == 1 ? cp->wib : d->mcux * cp->h;
                cp->bh = d->ncomp == 1 ? cp->hib : d->mcuy * cp->v;
                if (decode) {
                    cp->coef = (int16_t *)calloc(
                        (size_t)cp->bw * cp->bh * 64, sizeof(int16_t));
                    if (!cp->coef) return JE_MEMORY;
                }
            }
            if (!decode) return 0;
        } else if (m == 0xDA) {                               /* SOS */
            if (!d->frame) return JE_NOFRAME;
            if (sl < 1) return JE_TRUNCATED;
            if (d->scans++ == 0) {
                /* jdapimin.c default_decompress_parms, from the markers
                 * read so far */
                if (d->ncomp == 3)
                    d->rgb = !d->saw_jfif
                             && (d->saw_adobe ? d->adobe_transform == 0
                                              : d->comp[0].id == 82
                                                && d->comp[1].id == 71
                                                && d->comp[2].id == 66);
                d->ycck = d->ncomp == 4 && d->saw_adobe
                          && d->adobe_transform != 0;
            }
            int ns = s[0];
            if (ns < 1 || ns > d->ncomp || sl < 1 + 2 * ns + 3)
                return JE_FORMAT;
            comp_t *sc[4];
            for (int i = 0; i < ns; i++) {
                int id = s[1 + 2 * i], t = s[2 + 2 * i];
                sc[i] = NULL;
                for (int c = 0; c < d->ncomp; c++)
                    if (d->comp[c].id == id) sc[i] = &d->comp[c];
                if (!sc[i]) return JE_FORMAT;
                sc[i]->td = t >> 4;
                sc[i]->ta = t & 15;
                if (!d->arith && (sc[i]->td > 3 || sc[i]->ta > 3))
                    return JE_TABLE;
            }
            int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
            int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
            if (d->progressive
                && (se > 63 || ss > se || al > 13 || (ss == 0 && se != 0)
                    || (ss > 0 && ns != 1)))
                return JE_FORMAT;
            int64_t end;
            int r = decode_scan(d, data, n, p + len, ns, sc, ss, se, ah, al,
                                &end);
            if (r) return r;
            p = end;
            continue;
        }
        p += len;
    }
}

static void free_dec(dec_t *d) {
    for (int i = 0; i < 4; i++) {
        free(d->dc[i]);
        free(d->ac[i]);
        free(d->comp[i].coef);
    }
}

/* jdmaster.c prepare_range_limit_table, as the IDCT indexes it: x & 1023
 * for a wrapped 10-bit value x, centred on 0 -> 128. */
static void idct_range_limit(uint8_t *t) {
    for (int x = 0; x < 1024; x++) {
        int s = x < 512 ? x : x - 1024;
        int v = s + 128;
        t[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

/* Upsample component c into out (height x width) by the method libjpeg's
 * jinit_upsampler picks for its ratio to the largest factors (rx, ry):
 * full size, fancy h2v1, fancy h1v2, fancy h2v2 (h2v1 and h2v2 box below
 * 3 columns), else int_upsample's replication. */
static void upsample(const dec_t *d, const comp_t *c, const uint8_t *plane,
                     uint8_t *out) {
    int W = d->width, H = d->height, pw = c->bw * 8;
    int rx = d->max_h / c->h, ry = d->max_v / c->v;
    int dw = c->dw, dh = c->dh;
    if (rx == 1 && ry == 1) {
        for (int y = 0; y < H; y++)
            memcpy(out + (int64_t)y * W, plane + (int64_t)y * pw, W);
        return;
    }
    int fancy_h = (rx == 2 && (ry == 1 || ry == 2) && dw > 2);
    if ((rx == 2 && ry == 1 && fancy_h) || (rx == 1 && ry == 2)) {
        for (int y = 0; y < H; y++) {
            uint8_t *o = out + (int64_t)y * W;
            if (ry == 1) {                            /* h2v1 */
                const uint8_t *in = plane + (int64_t)y * pw;
                for (int x = 0; x < W; x++) {
                    int j = x >> 1;
                    int n3 = in[j] * 3;
                    if (x & 1) {
                        int nb = in[j + 1 < dw ? j + 1 : dw - 1];
                        o[x] = (uint8_t)((n3 + nb + 2) >> 2);
                    } else {
                        int nb = in[j > 0 ? j - 1 : 0];
                        o[x] = (uint8_t)((n3 + nb + 1) >> 2);
                    }
                }
            } else {                                  /* h1v2, fancy */
                int i = y >> 1;
                int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1)
                                 : (i > 0 ? i - 1 : 0);
                int bias = (y & 1) ? 2 : 1;
                const uint8_t *in0 = plane + (int64_t)i * pw;
                const uint8_t *in1 = plane + (int64_t)nb * pw;
                for (int x = 0; x < W; x++)
                    o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
            }
        }
        return;
    }
    if (rx == 2 && ry == 2 && fancy_h) {              /* h2v2, fancy */
        int *cs = (int *)malloc(sizeof(int) * (dw + 2));
        for (int y = 0; y < H; y++) {
            uint8_t *o = out + (int64_t)y * W;
            int i = y >> 1;
            int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1)
                             : (i > 0 ? i - 1 : 0);
            const uint8_t *in0 = plane + (int64_t)i * pw;
            const uint8_t *in1 = plane + (int64_t)nb * pw;
            for (int j = 0; j < dw; j++) cs[j + 1] = in0[j] * 3 + in1[j];
            cs[0] = cs[1];
            cs[dw + 1] = cs[dw];
            for (int x = 0; x < W; x++) {
                int j = (x >> 1) + 1;
                if (x & 1)
                    o[x] = (uint8_t)((cs[j] * 3 + cs[j + 1] + 7) >> 4);
                else
                    o[x] = (uint8_t)((cs[j] * 3 + cs[j - 1] + 8) >> 4);
            }
        }
        free(cs);
        return;
    }
    /* h2v1 / h2v2 box and int_upsample: each sample repeated rx x ry */
    for (int y = 0; y < H; y++) {
        const uint8_t *in = plane + (int64_t)(y / ry) * pw;
        uint8_t *o = out + (int64_t)y * W;
        for (int x = 0; x < W; x++) o[x] = in[x / rx];
    }
}

/* info: [height, width, components, status]. Returns 0, or an error
 * (< 0) for a file that is not a readable JPEG. */
EXPORT int jpeg_info(const uint8_t *data, int64_t n, int32_t *info) {
    dec_t d;
    memset(&d, 0, sizeof(d));
    int r = parse(&d, data, n, 0);
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = r > 0 ? r : 0;
    return r < 0 ? r : 0;
}

/* Decode to out (height * width * 3 RGB), 4 components by PIL's rule or,
 * when cmyk_cv2 is set, by cv2's. Returns 0, a status > 0 for a file this
 * decoder does not take, or an error < 0. */
EXPORT int jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
                       int64_t out_size, int32_t cmyk_cv2) {
    dec_t d;
    memset(&d, 0, sizeof(d));
    int r = parse(&d, data, n, 1);
    if (r) {
        free_dec(&d);
        return r;
    }
    int W = d.width, H = d.height;
    if (out_size < (int64_t)W * H * 3) {
        free_dec(&d);
        return JE_BUFFER;
    }
    uint8_t range_limit[1024];
    idct_range_limit(range_limit);
    uint8_t *full[4] = {NULL, NULL, NULL, NULL};
    for (int ci = 0; ci < d.ncomp; ci++) {
        comp_t *c = &d.comp[ci];
        int pw = c->bw * 8;
        uint8_t *plane = (uint8_t *)malloc((size_t)pw * c->bh * 8);
        full[ci] = (uint8_t *)malloc((size_t)W * H);
        if (!plane || !full[ci]) {
            free(plane);
            r = JE_MEMORY;
            break;
        }
        if (!c->latched) memcpy(c->q, d.qt[c->tq], sizeof(c->q));
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++)
                idct_islow(c->coef + ((int64_t)by * c->bw + bx) * 64, c->q,
                           plane + (int64_t)by * 8 * pw + bx * 8, pw,
                           range_limit);
        upsample(&d, c, plane, full[ci]);
        free(plane);
    }
    if (!r) {
        int64_t np = (int64_t)W * H;
        /* jdcolor.c build_ycc_rgb_table */
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        const int64_t one_half = (int64_t)1 << 15;
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = (int)((91881 * (int64_t)x + one_half) >> 16);
            cb_b[i] = (int)((116130 * (int64_t)x + one_half) >> 16);
            cr_g[i] = -46802 * (int64_t)x;
            cb_g[i] = -22554 * (int64_t)x + one_half;
        }
        if (d.ncomp == 1) {
            for (int64_t i = 0; i < np; i++)
                out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
        } else if (d.ncomp == 4) {
            for (int64_t i = 0; i < np; i++) {
                int cmy[3] = {full[0][i], full[1][i], full[2][i]};
                if (d.ycck) {      /* jdcolor.c ycck_cmyk_convert */
                    int y = cmy[0], cb = cmy[1], cr = cmy[2];
                    cmy[0] = 255 - (y + cr_r[cr]);
                    cmy[1] = 255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
                    cmy[2] = 255 - (y + cb_b[cb]);
                    for (int c = 0; c < 3; c++)
                        cmy[c] = cmy[c] < 0 ? 0 : cmy[c] > 255 ? 255 : cmy[c];
                }
                int k = full[3][i];
                for (int c = 0; c < 3; c++) {
                    int v;
                    if (cmyk_cv2) {
                        v = k - (((255 - cmy[c]) * k) >> 8);
                    } else {  /* PIL: "CMYK;I" inverts all four */
                        int t = (255 - cmy[c]) * k + 128;
                        v = k - (((t >> 8) + t) >> 8);
                    }
                    out[3 * i + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
                }
            }
        } else if (d.rgb) {    /* jdcolor.c rgb_rgb_convert */
            for (int64_t i = 0; i < np; i++)
                for (int c = 0; c < 3; c++) out[3 * i + c] = full[c][i];
        } else {
            /* jdcolor.c ycc_rgb_convert */
            for (int64_t i = 0; i < np; i++) {
                int y = full[0][i], cb = full[1][i], cr = full[2][i];
                int rv = y + cr_r[cr];
                int gv = y + (int)((cb_g[cb] + cr_g[cr]) >> 16);
                int bv = y + cb_b[cb];
                out[3 * i] = (uint8_t)(rv < 0 ? 0 : rv > 255 ? 255 : rv);
                out[3 * i + 1] = (uint8_t)(gv < 0 ? 0 : gv > 255 ? 255 : gv);
                out[3 * i + 2] = (uint8_t)(bv < 0 ? 0 : bv > 255 ? 255 : bv);
            }
        }
    }
    for (int ci = 0; ci < 4; ci++) free(full[ci]);
    free_dec(&d);
    return r;
}

/* ------------------------------------------------------------- encoder */

static const int std_luma_q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const int std_chroma_q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t dc_luma_bits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                         1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t dc_chroma_bits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                           1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t ac_luma_bits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                         5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t ac_luma_vals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t ac_chroma_bits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                           7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t ac_chroma_vals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
    uint16_t code[256];
    uint8_t size[256];
} ehuff_t;

typedef struct {
    uint8_t *out;
    int64_t cap, len;
    uint32_t acc;
    int nbits;
    int overflow;
} writer_t;

static void put_byte(writer_t *w, int b) {
    if (w->len < w->cap) w->out[w->len] = (uint8_t)b;
    else w->overflow = 1;
    w->len++;
}

static void put_bits(writer_t *w, uint32_t v, int n) {
    if (n == 0) return;
    w->acc = (w->acc << n) | (v & ((1u << n) - 1));
    w->nbits += n;
    while (w->nbits >= 8) {
        int b = (int)((w->acc >> (w->nbits - 8)) & 0xFF);
        put_byte(w, b);
        if (b == 0xFF) put_byte(w, 0);
        w->nbits -= 8;
    }
}

static void flush_bits(writer_t *w) {
    if (w->nbits > 0) put_bits(w, 0x7F, 8 - w->nbits);
    w->acc = 0;
    w->nbits = 0;
}

static void make_ehuff(ehuff_t *h, const uint8_t *bits, const uint8_t *vals) {
    memset(h, 0, sizeof(*h));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len - 1]; i++, k++) {
            h->code[vals[k]] = (uint16_t)code++;
            h->size[vals[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
}

static void put_marker_seg(writer_t *w, int m, const uint8_t *body, int n) {
    put_byte(w, 0xFF);
    put_byte(w, m);
    put_byte(w, (n + 2) >> 8);
    put_byte(w, (n + 2) & 0xFF);
    for (int i = 0; i < n; i++) put_byte(w, body[i]);
}

static void put_dht(writer_t *w, int cls_id, const uint8_t *bits,
                    const uint8_t *vals) {
    uint8_t body[1 + 16 + 256];
    int nv = 0;
    body[0] = (uint8_t)cls_id;
    for (int i = 0; i < 16; i++) {
        body[1 + i] = bits[i];
        nv += bits[i];
    }
    memcpy(body + 17, vals, nv);
    put_marker_seg(w, 0xC4, body, 17 + nv);
}

/* jfdctint.c jpeg_fdct_islow, in place; the output is scaled up by 8. */
static void fdct_islow(int *data) {
    int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
    int64_t tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
    for (int pass = 0; pass < 2; pass++) {
        for (int i = 0; i < 8; i++) {
            int st = pass ? 8 : 1;
            int *p = pass ? data + i : data + 8 * i;
            tmp0 = p[0] + p[7 * st];
            tmp7 = p[0] - p[7 * st];
            tmp1 = p[st] + p[6 * st];
            tmp6 = p[st] - p[6 * st];
            tmp2 = p[2 * st] + p[5 * st];
            tmp5 = p[2 * st] - p[5 * st];
            tmp3 = p[3 * st] + p[4 * st];
            tmp4 = p[3 * st] - p[4 * st];
            tmp10 = tmp0 + tmp3;
            tmp13 = tmp0 - tmp3;
            tmp11 = tmp1 + tmp2;
            tmp12 = tmp1 - tmp2;
            int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
            if (pass) {
                p[0] = (int)DESCALE(tmp10 + tmp11, PASS1_BITS);
                p[4 * st] = (int)DESCALE(tmp10 - tmp11, PASS1_BITS);
            } else {
                p[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
                p[4 * st] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
            }
            z1 = (tmp12 + tmp13) * FIX_0_541196100;
            p[2 * st] = (int)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
            p[6 * st] = (int)DESCALE(z1 + tmp12 * (-FIX_1_847759065), sh);
            z1 = tmp4 + tmp7;
            z2 = tmp5 + tmp6;
            z3 = tmp4 + tmp6;
            z4 = tmp5 + tmp7;
            z5 = (z3 + z4) * FIX_1_175875602;
            tmp4 = tmp4 * FIX_0_298631336;
            tmp5 = tmp5 * FIX_2_053119869;
            tmp6 = tmp6 * FIX_3_072711026;
            tmp7 = tmp7 * FIX_1_501321110;
            z1 = z1 * (-FIX_0_899976223);
            z2 = z2 * (-FIX_2_562915447);
            z3 = z3 * (-FIX_1_961570560);
            z4 = z4 * (-FIX_0_390180644);
            z3 += z5;
            z4 += z5;
            p[7 * st] = (int)DESCALE(tmp4 + z1 + z3, sh);
            p[5 * st] = (int)DESCALE(tmp5 + z2 + z4, sh);
            p[3 * st] = (int)DESCALE(tmp6 + z2 + z3, sh);
            p[st] = (int)DESCALE(tmp7 + z1 + z4, sh);
        }
    }
}

static void encode_block(writer_t *w, const int *coef, int *pred,
                         const ehuff_t *dc, const ehuff_t *ac) {
    int temp = coef[0] - *pred, temp2;
    *pred = coef[0];
    temp2 = temp;
    if (temp < 0) {
        temp = -temp;
        temp2--;
    }
    int nbits = 0;
    while (temp) {
        nbits++;
        temp >>= 1;
    }
    put_bits(w, dc->code[nbits], dc->size[nbits]);
    put_bits(w, (uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
        temp = coef[natural_order[k]];
        if (temp == 0) {
            r++;
            continue;
        }
        while (r > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            r -= 16;
        }
        temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            temp2--;
        }
        nbits = 1;
        while ((temp >>= 1)) nbits++;
        int i = (r << 4) + nbits;
        put_bits(w, ac->code[i], ac->size[i]);
        put_bits(w, (uint32_t)temp2, nbits);
        r = 0;
    }
    if (r > 0) put_bits(w, ac->code[0], ac->size[0]);
}

/* img: height x width x 3 RGB uint8; chroma at half resolution both ways
 * (4:2:0) or full (4:4:4). Returns the bytes written, or an error < 0
 * (JE_BUFFER when cap is too small). */
EXPORT int64_t jpeg_encode(const uint8_t *img, int32_t height, int32_t width,
                           int32_t quality, int32_t subsample,
                           uint8_t *out, int64_t cap) {
    if (height < 1 || width < 1 || height > 65535 || width > 65535)
        return JE_FORMAT;
    /* jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (baseline) */
    int q = quality < 1 ? 1 : quality > 100 ? 100 : quality;
    int scale = q < 50 ? 5000 / q : 200 - q * 2;
    int qt[2][64];
    for (int i = 0; i < 64; i++) {
        long t0 = ((long)std_luma_q[i] * scale + 50L) / 100L;
        long t1 = ((long)std_chroma_q[i] * scale + 50L) / 100L;
        qt[0][i] = (int)(t0 <= 0 ? 1 : t0 > 255 ? 255 : t0);
        qt[1][i] = (int)(t1 <= 0 ? 1 : t1 > 255 ? 255 : t1);
    }
    const int nc = 3;
    int mh = subsample ? 2 : 1, mv = mh;
    int mcux = (width + 8 * mh - 1) / (8 * mh);
    int mcuy = (height + 8 * mv - 1) / (8 * mv);
    int pw = mcux * 8 * mh, ph = mcuy * 8 * mv;
    /* full-size planes, edges replicated (jcprepct.c expand_bottom_edge,
     * jcsample.c expand_right_edge), colour converted (jccolor.c) */
    uint8_t *planes[3] = {NULL, NULL, NULL};
    uint8_t *sub[3] = {NULL, NULL, NULL};
    int64_t rc = 0;
    for (int c = 0; c < nc; c++) {
        planes[c] = (uint8_t *)malloc((size_t)pw * ph);
        if (!planes[c]) rc = JE_MEMORY;
    }
    if (rc) goto done;
    {
        int64_t tab[8 * 256];
        const int64_t one_half = (int64_t)1 << 15;
        const int64_t cbcr_off = (int64_t)128 << 16;
        for (int i = 0; i < 256; i++) {
            tab[i] = 19595 * (int64_t)i;                        /* R_Y */
            tab[256 + i] = 38470 * (int64_t)i;                  /* G_Y */
            tab[512 + i] = 7471 * (int64_t)i + one_half;        /* B_Y */
            tab[768 + i] = -11059 * (int64_t)i;                 /* R_CB */
            tab[1024 + i] = -21709 * (int64_t)i;                /* G_CB */
            tab[1280 + i] = 32768 * (int64_t)i + cbcr_off + one_half - 1;
            tab[1536 + i] = -27439 * (int64_t)i;                /* G_CR */
            tab[1792 + i] = -5329 * (int64_t)i;                 /* B_CR */
        }
        for (int y = 0; y < ph; y++) {
            int sy = y < height ? y : height - 1;
            for (int x = 0; x < pw; x++) {
                int sx = x < width ? x : width - 1;
                const uint8_t *px = img + ((int64_t)sy * width + sx) * 3;
                int64_t o = (int64_t)y * pw + x;
                int r = px[0], g = px[1], b = px[2];
                planes[0][o] = (uint8_t)((tab[r] + tab[256 + g]
                                          + tab[512 + b]) >> 16);
                planes[1][o] = (uint8_t)((tab[768 + r] + tab[1024 + g]
                                          + tab[1280 + b]) >> 16);
                planes[2][o] = (uint8_t)((tab[1280 + r] + tab[1536 + g]
                                          + tab[1792 + b]) >> 16);
            }
        }
    }
    /* chroma downsampling (jcsample.c h2v2_downsample) */
    int cw = pw / mh, ch = ph / mv;
    for (int c = 1; c < nc; c++) {
        if (mh == 1) {
            sub[c] = planes[c];
            planes[c] = NULL;
            continue;
        }
        sub[c] = (uint8_t *)malloc((size_t)cw * ch);
        if (!sub[c]) {
            rc = JE_MEMORY;
            goto done;
        }
        for (int y = 0; y < ch; y++) {
            int bias = 1;                  /* 1, 2, 1, 2, ... */
            for (int x = 0; x < cw; x++) {
                const uint8_t *p0 = planes[c] + (int64_t)(2 * y) * pw + 2 * x;
                const uint8_t *p1 = p0 + pw;
                sub[c][(int64_t)y * cw + x] =
                    (uint8_t)((p0[0] + p0[1] + p1[0] + p1[1] + bias) >> 2);
                bias ^= 3;
            }
        }
        /* jcprepct.c pads the last iMCU row with copies of the last
         * downsampled row, not with downsampled copies of the last image
         * row */
        int real = (height + mv - 1) / mv;
        for (int y = real; y < ch; y++)
            memcpy(sub[c] + (int64_t)y * cw, sub[c] + (int64_t)(real - 1) * cw,
                   cw);
    }
    sub[0] = planes[0];
    planes[0] = NULL;
    {
        writer_t w = {out, cap, 0, 0, 0, 0};
        ehuff_t dch[2], ach[2];
        make_ehuff(&dch[0], dc_luma_bits, dc_vals);
        make_ehuff(&ach[0], ac_luma_bits, ac_luma_vals);
        make_ehuff(&dch[1], dc_chroma_bits, dc_vals);
        make_ehuff(&ach[1], ac_chroma_bits, ac_chroma_vals);
        put_byte(&w, 0xFF);
        put_byte(&w, 0xD8);
        static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                         0, 1, 0, 1, 0, 0};
        put_marker_seg(&w, 0xE0, jfif, 14);
        for (int t = 0; t < 2; t++) {
            uint8_t body[65];
            body[0] = (uint8_t)t;
            for (int k = 0; k < 64; k++)
                body[1 + k] = (uint8_t)qt[t][natural_order[k]];
            put_marker_seg(&w, 0xDB, body, 65);
        }
        uint8_t sof[6 + 9];
        sof[0] = 8;
        sof[1] = (uint8_t)(height >> 8);
        sof[2] = (uint8_t)(height & 0xFF);
        sof[3] = (uint8_t)(width >> 8);
        sof[4] = (uint8_t)(width & 0xFF);
        sof[5] = (uint8_t)nc;
        for (int c = 0; c < nc; c++) {
            sof[6 + 3 * c] = (uint8_t)(c + 1);
            sof[7 + 3 * c] = (uint8_t)(c == 0 ? (mh << 4) | mv : 0x11);
            sof[8 + 3 * c] = (uint8_t)(c == 0 ? 0 : 1);
        }
        put_marker_seg(&w, 0xC0, sof, 6 + 3 * nc);
        put_dht(&w, 0x00, dc_luma_bits, dc_vals);
        put_dht(&w, 0x10, ac_luma_bits, ac_luma_vals);
        put_dht(&w, 0x01, dc_chroma_bits, dc_vals);
        put_dht(&w, 0x11, ac_chroma_bits, ac_chroma_vals);
        uint8_t sos[1 + 6 + 3];
        sos[0] = (uint8_t)nc;
        for (int c = 0; c < nc; c++) {
            sos[1 + 2 * c] = (uint8_t)(c + 1);
            sos[2 + 2 * c] = (uint8_t)(c == 0 ? 0x00 : 0x11);
        }
        sos[1 + 2 * nc] = 0;
        sos[2 + 2 * nc] = 63;
        sos[3 + 2 * nc] = 0;
        put_marker_seg(&w, 0xDA, sos, 4 + 2 * nc);

        int preds[3] = {0, 0, 0};
        int blk[64], coef[64];
        int64_t cwid[3], chgt[3];   /* the component's samples */
        for (int c = 0; c < nc; c++) {
            int h = c == 0 ? mh : 1, v = c == 0 ? mv : 1;
            cwid[c] = ((int64_t)width * h + mh - 1) / mh;
            chgt[c] = ((int64_t)height * v + mv - 1) / mv;
        }
        for (int my = 0; my < mcuy; my++) {
            for (int mx = 0; mx < mcux; mx++) {
                for (int c = 0; c < nc; c++) {
                    int h = c == 0 ? mh : 1, v = c == 0 ? mv : 1;
                    int spw = c == 0 ? pw : cw;
                    int wib = (int)((cwid[c] + 7) / 8);
                    int hib = (int)((chgt[c] + 7) / 8);
                    int last_dc = 0;
                    for (int yy = 0; yy < v; yy++) {
                        for (int xx = 0; xx < h; xx++) {
                            int by = my * v + yy, bx = mx * h + xx;
                            if (by >= hib) {
                                /* jccoefct.c: a dummy row at the bottom
                                 * takes the DC of the block before it */
                                memset(coef, 0, sizeof(coef));
                                coef[0] = last_dc;
                            } else if (bx >= wib) {
                                memset(coef, 0, sizeof(coef));
                                coef[0] = last_dc;
                            } else {
                                const uint8_t *src =
                                    sub[c] + (int64_t)by * 8 * spw + bx * 8;
                                for (int r = 0; r < 8; r++)
                                    for (int k = 0; k < 8; k++)
                                        blk[8 * r + k] =
                                            src[(int64_t)r * spw + k] - 128;
                                fdct_islow(blk);
                                const int *qq = qt[c == 0 ? 0 : 1];
                                for (int k = 0; k < 64; k++) {
                                    int qv = qq[k] << 3, t = blk[k];
                                    if (t < 0) {
                                        t = -t + (qv >> 1);
                                        t = t >= qv ? t / qv : 0;
                                        t = -t;
                                    } else {
                                        t += qv >> 1;
                                        t = t >= qv ? t / qv : 0;
                                    }
                                    coef[k] = t;
                                }
                            }
                            last_dc = coef[0];
                            int t = c == 0 ? 0 : 1;
                            encode_block(&w, coef, &preds[c], &dch[t],
                                         &ach[t]);
                        }
                    }
                }
            }
        }
        flush_bits(&w);
        put_byte(&w, 0xFF);
        put_byte(&w, 0xD9);
        rc = w.overflow ? JE_BUFFER : w.len;
    }
done:
    for (int c = 0; c < 3; c++) {
        free(planes[c]);
        free(sub[c]);
    }
    return rc;
}
