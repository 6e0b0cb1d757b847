// Building blocks of the tensor-core window-attention kernels (Hopper,
// sm_90a): the forward K5 (window_attn_nhwc_mma.cu), its backward K6
// (window_attn_nhwc_bwd_mma.cu), the token-major forward K4
// (window_attn_tokens_mma.cu), the 256-token forwards of K4 and K5
// (window_attn_mma256.cu) and the 256-token K6 (window_attn_mma256_bwd.cu).
// PTX wrappers for 16-byte cp.async, ldmatrix,
// stmatrix and mma.sync m16n8k16 (bf16 in, fp32 accumulate), the quad
// reductions over one mma fragment row, the NHWC and token-major layout
// policies, the forward's three steps over a staged 64-token window
// (S = Q K^T, the row softmax, O = P V) that K5 and K4 share, and the
// same steps over one 64-key block with an online softmax
// (FlashAttention-2's form) for windows of more than 64 tokens.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attn_common.cuh"

// NHWC maps with windows of WS x WS (8 or 16): token t of a window sits at
// pixel (b, wi * WS + t / WS, wj * WS + t % WS); its head-h slice at channel
// h * hd of a row of `in_stride` (operands) or `out_stride` (output)
// elements.
template <int WS>
struct NhwcWindowLayout {
  static_assert(WS == 8 || WS == 16, "windows of 8 x 8 or 16 x 16");
  static constexpr int kLog = WS == 8 ? 3 : 4;
  int64_t in_stride;
  int64_t out_stride;

  // the window's top-left pixel
  __device__ __forceinline__ int64_t origin(const WaGeometry& g,
                                            int w) const {
    const int b = w / g.nW, wl = w - b * g.nW;
    const int ww = g.Wp >> kLog;
    const int wi = wl / ww, wj = wl - wi * ww;
    return ((int64_t)b * g.Hp + wi * WS) * g.Wp + wj * WS;
  }
  __device__ __forceinline__ int64_t pixel(const WaGeometry& g, int64_t o,
                                           int t) const {
    return o + (int64_t)(t >> kLog) * g.Wp + (t & (WS - 1));
  }
  __device__ __forceinline__ int64_t in(const WaGeometry& g, int64_t o, int h,
                                        int t) const {
    return pixel(g, o, t) * in_stride + h * g.hd;
  }
  __device__ __forceinline__ int64_t out(const WaGeometry& g, int64_t o,
                                         int h, int t) const {
    return pixel(g, o, t) * out_stride + h * g.hd;
  }
};

// the 8 x 8 windows of the 64-token bodies (K5, K6)
using NhwcLayout = NhwcWindowLayout<8>;

// Token-major operands (nWt, nH, N, hd), the output likewise: window w and
// head h start at (w * nH + h) * N * hd, token rows hd * 2 bytes apart.
struct TokensLayout {
  __device__ __forceinline__ int64_t origin(const WaGeometry& g,
                                            int w) const {
    return ((int64_t)w * g.nH) * g.N;
  }
  __device__ __forceinline__ int64_t in(const WaGeometry& g, int64_t o, int h,
                                        int t) const {
    return (o + (int64_t)h * g.N + t) * g.hd;
  }
  __device__ __forceinline__ int64_t out(const WaGeometry& g, int64_t o,
                                         int h, int t) const {
    return in(g, o, h, t);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 4 bytes (for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes when `bytes` is 16, zeros (nothing read) when it is 0
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ldmatrix reversed: four 8 x 8 bf16 matrices from mma fragments into
// shared memory, lanes 8 m .. 8 m + 7 giving the row addresses of matrix m
__device__ __forceinline__ void stsm_x4(uint32_t addr,
                                        const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :
      : "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// d += a . b for one 16 x 8 tile (k 16): bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> one register of two bf16, lo in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The forward's steps for one warp's 16 query rows of a 64-token window
// staged in shared memory (rows `pitch` bytes apart; lane's fragment rows
// r0 = warp * 16 + lane / 4 and r0 + 8, columns 8 j + 2 (lane % 4), + 1).

// the warp's 16 query rows as mma A fragments, one per k-step of 16
template <int HD>
__device__ __forceinline__ void wa_load_q(uint32_t (&qa)[HD / 16][4],
                                          uint32_t qs, int pitch, int warp,
                                          int lane) {
  const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * pitch +
                        (kk * 16 + (mi >> 1) * 8) * 2);
}

// S += Q K^T for 64 keys staged at ks: 8 n-tiles of 8 keys x HD / 16
// k-steps, K through ldmatrix ([key][d] rows are B's column layout)
template <int HD>
__device__ __forceinline__ void wa_qk_block(float (&s)[8][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            uint32_t ks, int pitch,
                                            int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1,
              ks + (8 * j + (lane & 7)) * pitch + (kk * 16 + (mi & 1) * 8) * 2);
      mma_bf16(s[j], qa[kk], b0, b1);
    }
}

// S = Q K^T over a staged 64-token window
template <int HD>
__device__ __forceinline__ void wa_qk_tile(float (&s)[8][4], uint32_t qs,
                                           uint32_t ks, int pitch, int warp,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  uint32_t qa[HD / 16][4];
  wa_load_q<HD>(qa, qs, pitch, warp, lane);
  wa_qk_block<HD>(s, qa, ks, pitch, lane);
}

// the row softmax of base-2 logits, in place: s = exp2(s - row max) (the
// max and sum over the 4 lanes of a quad); i0, i1 = 1 / row sum of rows r0
// and r0 + 8
__device__ __forceinline__ void wa_softmax_rows(float (&s)[8][4], float& i0,
                                                float& i1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2_approx(s[j][0] - m0);
    s[j][1] = exp2_approx(s[j][1] - m0);
    s[j][2] = exp2_approx(s[j][2] - m1);
    s[j][3] = exp2_approx(s[j][3] - m1);
    z0 += s[j][0] + s[j][1];
    z1 += s[j][2] + s[j][3];
  }
  i0 = 1.f / quad_sum(z0);
  i1 = 1.f / quad_sum(z1);
}

// O += P V over 64 keys: P = s * (i0, i1) rounded to bf16 from the S
// registers (n-tiles 2 kk and 2 kk + 1 are P's A fragment of k-step kk), V
// [key][d] through ldmatrix.trans
template <int HD>
__device__ __forceinline__ void wa_pv_block(float (&o)[HD / 8][4],
                                            const float (&s)[8][4], float i0,
                                            float i1, uint32_t vs, int pitch,
                                            int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0),
        pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1),
        pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0),
        pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1)};
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * pitch +
                            (dn * 8 + (mi >> 1) * 8) * 2);
      mma_bf16(o[dn], pa, vb[0], vb[1]);
      mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
    }
  }
}

// O = P V over a staged 64-token window, P normalized by (i0, i1)
template <int HD>
__device__ __forceinline__ void wa_pv_tile(float (&o)[HD / 8][4],
                                           const float (&s)[8][4], float i0,
                                           float i1, uint32_t vs, int pitch,
                                           int lane) {
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  wa_pv_block<HD>(o, s, i0, i1, vs, pitch, lane);
}

// Windows of more than 64 tokens: one 64-key block of the online softmax
// (FlashAttention-2's form) for the warp's 16 query rows. s holds the
// block's logits in units of 1 / sl (the base-2 logit is s * sl, sl > 0;
// -inf where excluded); m0, m1 are the running row maxima of rows r0,
// r0 + 8 in the same units (the same in the 4 lanes of a quad), l0, l1
// this lane's share of the running row sums, o the output accumulators.
// When a row's max moves, l and o are rescaled by exp2((m_old - m_new)
// sl); s becomes p = exp2(s sl - m_new sl) (one fma and one ex2 a logit),
// unnormalized, for wa_pv_block with i0 = i1 = 1. A row whose keys so far
// are all excluded keeps max -inf and p = 0. The caller scales o by
// 1 / quad_sum(l) after the last block.
template <int HD>
__device__ __forceinline__ void wa_online_softmax(float (&s)[8][4],
                                                  float (&o)[HD / 8][4],
                                                  float sl, float& m0,
                                                  float& m1, float& l0,
                                                  float& l1) {
  float x0 = m0, x1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
    x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
  }
  x0 = quad_max(x0);
  x1 = quad_max(x1);
  const float u0 = x0 == -INFINITY ? 0.f : x0 * sl;
  const float u1 = x1 == -INFINITY ? 0.f : x1 * sl;
  const float a0 = exp2_approx(fmaf(m0, sl, -u0));
  const float a1 = exp2_approx(fmaf(m1, sl, -u1));
  m0 = x0;
  m1 = x1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    o[dn][0] *= a0;
    o[dn][1] *= a0;
    o[dn][2] *= a1;
    o[dn][3] *= a1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2_approx(fmaf(s[j][0], sl, -u0));
    s[j][1] = exp2_approx(fmaf(s[j][1], sl, -u0));
    s[j][2] = exp2_approx(fmaf(s[j][2], sl, -u1));
    s[j][3] = exp2_approx(fmaf(s[j][3], sl, -u1));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
}
