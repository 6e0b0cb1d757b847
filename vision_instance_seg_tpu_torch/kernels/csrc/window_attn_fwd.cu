// Window attention, forward (Hopper, sm_90a): one kernel body for three TPU
// kernels of vision_instance_seg_tpu/kernels/window_attention.py:
//   K4a _fused_window_attention_impl  token-major, additive mask tensor;
//   K4b _fused_wa_geo_impl            token-major, region labels;
//   K5  _wa_nhwc_impl                 NHWC fused qkv or split q/k/v maps,
//                                     region + pad labels.
// Per (window, head): s = (q * scale) . k^T in fp32, plus rel[h] and the
// mask (K4a: s + (rel + mask[window]); K4b, K5: s + rel where the labels
// agree, s - 1e9 where they do not); a row softmax in fp32; p rounded to the
// operand type; out = p . v accumulated in fp32 and written in the operand
// type, in the caller's layout (at channel h * hd of the NHWC output).
//
// Bound: memory. At Swin stage 1 in serving (qkv (8, 200, 200, 288) bf16)
// the call reads 184 MB and writes 61 MB, 73 us at 3.35 TB/s, against
// 7.9 GFLOP (0.008 ms on the tensor cores). The TPU kernels' layout tricks
// (two windows per 128-row MXU tile with -inf cross quadrants, N padded to
// 64, windows paired along a row with a solo tail, ws % 8 for the sublane
// tiling) exist for the MXU and its (8, 128) tiles and are not carried over.
//
// Design, simple first: one block of 256 threads per (window, head). The
// block loads its window's q (pre-scaled), k and v head slices into shared
// memory as fp32 (N x hd each, k rows padded to hd + 1 so that lanes reading
// different keys hit different banks). Each warp then owns query rows: a
// lane computes the logits of keys lane, lane + 32, ... (N <= 256: up to 8
// per lane), the row max and sum are warp shuffles, the row of p goes to a
// per-warp buffer of N floats, and the lanes then take output channels
// (d = lane, lane + 32) and sum p . v over the keys. Every output element is
// written once; nothing is atomic. At N = 256 and hd = 64 the block holds
// 206 KB of shared memory. The products run on the fp32 cores: this body
// serves fp32 calls, and bf16 calls that the tensor-core bodies do not take
// (windows past 64 tokens; K4 at a head dim that is not a multiple of 16).

#include "window_attn_common.cuh"

enum WaMask { WA_MASK_TENSOR = 0, WA_MASK_LABELS = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerLane = WA_MAX_TOKENS / 32;

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int LAYOUT, int MASK>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ rel,
                           const float* __restrict__ mask, T* __restrict__ out,
                           WaGeometry g) {
  extern __shared__ float smem[];
  const int N = g.N, hd = g.hd, kst = hd + 1;
  float* qs = smem;                    // N x hd, scaled
  float* ks = qs + N * hd;             // N x (hd + 1)
  float* vs = ks + N * kst;            // N x hd
  float* prow = vs + N * hd;           // kWarps x N
  int* lab = reinterpret_cast<int*>(prow + kWarps * N);  // N
  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int wl = w % g.nW;

  for (int i = tid; i < N * hd; i += kThreads) {
    const int t = i / hd, d = i - t * hd;
    qs[i] = wa_load(q + wa_in_offset<LAYOUT>(g, w, h, t, 0) + d) * g.scale;
    ks[t * kst + d] = wa_load(k + wa_in_offset<LAYOUT>(g, w, h, t, 1) + d);
    vs[i] = wa_load(v + wa_in_offset<LAYOUT>(g, w, h, t, 2) + d);
  }
  if (MASK == WA_MASK_LABELS)
    for (int t = tid; t < N; t += kThreads) lab[t] = wa_label(g, wl, t);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const float* relh = rel + (int64_t)h * N * N;
  const float* mw = MASK == WA_MASK_TENSOR ? mask + (int64_t)wl * N * N
                                           : nullptr;
  float* pw = prow + warp * N;
  for (int i = warp; i < N; i += kWarps) {
    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      s[c] = -INFINITY;
      if (j < N) {
        float a = 0.f;
        for (int d = 0; d < hd; ++d) a = fmaf(qs[i * hd + d], ks[j * kst + d], a);
        if (MASK == WA_MASK_TENSOR)
          a += relh[i * N + j] + mw[i * N + j];
        else
          a += lab[i] == lab[j] ? relh[i * N + j] : WA_NEG_INF;
        s[c] = a;
      }
      mx = fmaxf(mx, s[c]);
    }
    mx = warp_max(mx);
    float e[kKeysPerLane], sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      e[c] = lane + 32 * c < N ? expf(s[c] - mx) : 0.f;
      sum += e[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c)
      if (lane + 32 * c < N)
        pw[lane + 32 * c] = round_to(e[c] / sum, static_cast<const T*>(nullptr));
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float a = 0.f;
      for (int j = 0; j < N; ++j) a = fmaf(pw[j], vs[j * hd + d], a);
      wa_store(out + wa_out_offset<LAYOUT>(g, w, h, i) + d, a);
    }
    __syncwarp();
  }
}

template <typename T, int LAYOUT, int MASK>
static int launch(const void* q, const void* k, const void* v,
                  const float* rel, const float* mask, void* out,
                  const WaGeometry& g, int total_windows, void* stream) {
  const size_t smem = (size_t)(g.N * (3 * g.hd + 1) + kWarps * g.N) *
                          sizeof(float) + g.N * sizeof(int);
  auto kern = window_attn_fwd_kernel<T, LAYOUT, MASK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(total_windows, g.nH);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), rel, mask, static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <int LAYOUT, int MASK>
static int launch_typed(int is_bf16, const void* q, const void* k,
                        const void* v, const float* rel, const float* mask,
                        void* out, const WaGeometry& g, int total_windows,
                        void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16, LAYOUT, MASK>(q, k, v, rel, mask, out, g,
                                               total_windows, stream);
  return launch<float, LAYOUT, MASK>(q, k, v, rel, mask, out, g,
                                     total_windows, stream);
}

extern "C" {

// K4a: q/k/v/out (total_windows, nH, N, hd); mask (nW, N, N) fp32 added to
// window w's logits at w % nW. Returns cudaGetLastError() (0 = launched).
int window_attn_fwd_tokens_mask(const void* q, const void* k, const void* v,
                                const void* rel, const void* mask, void* out,
                                int is_bf16, int total_windows, int nW, int nH,
                                int N, int hd, float scale, void* stream) {
  WaGeometry g = {nW, nH, N, hd, nH * hd, 0, 0, 1, 0, 0, 0, scale};
  if (const int e = wa_check(g, WA_TOKENS)) return e;
  if (total_windows < 1 || total_windows % nW)
    return (int)cudaErrorInvalidValue;
  return launch_typed<WA_TOKENS, WA_MASK_TENSOR>(
      is_bf16, q, k, v, static_cast<const float*>(rel),
      static_cast<const float*>(mask), out, g, total_windows, stream);
}

// K4b: as K4a with the region labels of the (Hp, Wp, ws, shift) geometry.
int window_attn_fwd_tokens_geo(const void* q, const void* k, const void* v,
                               const void* rel, void* out, int is_bf16,
                               int total_windows, int nH, int hd, int Hp,
                               int Wp, int ws, int shift, float scale,
                               void* stream) {
  if (ws < 1 || Hp % ws || Wp % ws) return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  WaGeometry g = {nW, nH, ws * ws, hd, nH * hd, Hp, Wp, ws, shift, 0, 0, scale};
  if (const int e = wa_check(g, WA_TOKENS)) return e;
  if (total_windows < 1 || total_windows % nW)
    return (int)cudaErrorInvalidValue;
  return launch_typed<WA_TOKENS, WA_MASK_LABELS>(
      is_bf16, q, k, v, static_cast<const float*>(rel), nullptr, out, g,
      total_windows, stream);
}

// K5: fused (q = k = v = the (B, Hp, Wp, 3C) qkv map) or split maps; out
// (B, Hp, Wp, C). pad_h = pad_w = 0: no pad labels.
int window_attn_fwd_nhwc(const void* q, const void* k, const void* v,
                         const void* rel, void* out, int is_bf16, int fused,
                         int B, int nH, int C, int Hp, int Wp, int ws,
                         int shift, int pad_h, int pad_w, float scale,
                         void* stream) {
  if (ws < 1 || nH < 1 || C % nH) return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  WaGeometry g = {nW, nH, ws * ws, C / nH, C, Hp, Wp, ws, shift,
                  pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  if (fused)
    return launch_typed<WA_NHWC_FUSED, WA_MASK_LABELS>(
        is_bf16, q, k, v, static_cast<const float*>(rel), nullptr, out, g,
        B * nW, stream);
  return launch_typed<WA_NHWC_SPLIT, WA_MASK_LABELS>(
      is_bf16, q, k, v, static_cast<const float*>(rel), nullptr, out, g,
      B * nW, stream);
}

const char* window_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
