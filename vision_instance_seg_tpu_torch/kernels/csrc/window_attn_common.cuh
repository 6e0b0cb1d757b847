// Shared geometry of the window-attention kernels (forward and backward).
//
// A window is ws x ws tokens (N = ws * ws <= 256) of a padded map Hp x Wp,
// windows row-major within an image: window wl of an image sits at window
// row wl / (Wp / ws) and column wl % (Wp / ws). Token t of a window is map
// row wi * ws + t / ws, column wj * ws + t % ws. Three operand layouts:
//   WA_TOKENS      q/k/v (B * nW, nH, N, hd), the output likewise;
//   WA_NHWC_FUSED  one qkv map (B, Hp, Wp, 3C): q at channel h * hd, k at
//                  C + h * hd, v at 2C + h * hd; output (B, Hp, Wp, C);
//   WA_NHWC_SPLIT  q, k, v maps (B, Hp, Wp, C) each; output likewise.
// Labels (the TPU kernels' in-kernel masks): the shifted-window region
// 3 ry + rx at rolled coordinates when shift > 0, plus 10 x [the token is
// canvas padding at pre-roll coordinates] when pad_h > 0. Pairs of tokens
// with different labels are excluded (logit -1e9).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WA_MAX_TOKENS 256  // windows up to 16 x 16
#define WA_MAX_HEAD_DIM 64
#define WA_NEG_INF (-1e9f)
#define WA_MAX_SMEM 232448  // dynamic shared memory a block can opt into

enum WaLayout { WA_TOKENS = 0, WA_NHWC_FUSED = 1, WA_NHWC_SPLIT = 2 };

struct WaGeometry {
  int nW;            // windows per image
  int nH;            // heads
  int N;             // tokens per window
  int hd;            // head dim
  int C;             // nH * hd
  int Hp, Wp;        // padded map (NHWC layouts and labels)
  int ws, shift;
  int pad_h, pad_w;  // real extents for the pad labels; 0 = none
  float scale;
};

// element access in the operand type T, arithmetic in fp32
__device__ __forceinline__ float wa_load(const float* p) { return *p; }
__device__ __forceinline__ float wa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void wa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void wa_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element offset of channel 0 of head h, token t of window w (w = b * nW +
// wl) in operand `part` (0 q, 1 k, 2 v) of the layout.
template <int LAYOUT>
__device__ __forceinline__ int64_t wa_in_offset(const WaGeometry& g, int w,
                                                int h, int t, int part) {
  if (LAYOUT == WA_TOKENS) return (((int64_t)w * g.nH + h) * g.N + t) * g.hd;
  const int b = w / g.nW, wl = w - b * g.nW;
  const int ww = g.Wp / g.ws;
  const int wi = wl / ww, wj = wl - wi * ww;
  const int ty = t / g.ws;
  const int64_t pix =
      ((int64_t)b * g.Hp + wi * g.ws + ty) * g.Wp + wj * g.ws + t - ty * g.ws;
  if (LAYOUT == WA_NHWC_FUSED) return pix * 3 * g.C + part * g.C + h * g.hd;
  return pix * g.C + h * g.hd;
}

// Offset of the same element in the output (B, Hp, Wp, C) or (nWt, nH, N,
// hd) tensor.
template <int LAYOUT>
__device__ __forceinline__ int64_t wa_out_offset(const WaGeometry& g, int w,
                                                 int h, int t) {
  return wa_in_offset<LAYOUT == WA_NHWC_FUSED ? WA_NHWC_SPLIT : LAYOUT>(
      g, w, h, t, 0);
}

// the label of map cell (gy, gx)
__device__ __forceinline__ int wa_label_at(const WaGeometry& g, int gy,
                                           int gx) {
  int lab = 0;
  if (g.shift > 0)
    lab = 3 * ((gy >= g.Hp - g.ws) + (gy >= g.Hp - g.shift)) +
          (gx >= g.Wp - g.ws) + (gx >= g.Wp - g.shift);
  if (g.pad_h > 0) {
    int oy = gy + g.shift, ox = gx + g.shift;  // pre-roll coordinates
    if (oy >= g.Hp) oy -= g.Hp;
    if (ox >= g.Wp) ox -= g.Wp;
    lab += 10 * (oy >= g.pad_h || ox >= g.pad_w);
  }
  return lab;
}

// the label of token t of window wl of an image
__device__ __forceinline__ int wa_label(const WaGeometry& g, int wl, int t) {
  const int ww = g.Wp / g.ws;
  const int wi = wl / ww, wj = wl - wi * ww;
  return wa_label_at(g, wi * g.ws + t / g.ws, wj * g.ws + t % g.ws);
}

// Checks what both kernels assume; returns 0 or cudaErrorInvalidValue.
static inline int wa_check(const WaGeometry& g, int layout) {
  if (g.N < 1 || g.N > WA_MAX_TOKENS || g.hd < 1 || g.hd > WA_MAX_HEAD_DIM ||
      g.nH < 1 || g.nW < 1)
    return (int)cudaErrorInvalidValue;
  if (layout != WA_TOKENS &&
      (g.ws * g.ws != g.N || g.Hp % g.ws || g.Wp % g.ws || g.C != g.nH * g.hd))
    return (int)cudaErrorInvalidValue;
  return 0;
}
