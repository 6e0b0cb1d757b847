// Token-major window attention forward on the tensor cores (Hopper, sm_90a),
// bf16 only: K4a and K4b of vision_instance_seg_tpu/kernels/window_attention.py,
//   K4a _fused_window_attention_impl (:162)  an additive (nW, N, N) mask;
//   K4b _fused_wa_geo_impl (:220)            region labels from the
//                                            (Hp, Wp, ws, shift) geometry,
//                                            excluded pairs at -1e9.
// q, k, v and out are (nWt, nH, N, hd) contiguous; per (window, head)
// out = softmax(q . k^T * scale + rel[h] + mask) . v, windows of N <= 64
// tokens (ws 4, 7, 8), head dim HD a multiple of 16 up to 64. fp32 calls,
// windows past 64 tokens and other head dims take the SIMT body of
// window_attn_fwd.cu (kernels/window_attention.py `tokens_fwd_body`).
//
// Bound: bytes. K4b at Swin stage 1 in serving ((5000, 3, 64, 32) bf16):
// 245.8 MB read and written, 73 us at 3.35 TB/s, against 7.9 GFLOP, 8 us on
// the tensor cores. K4a reads its (nW, N, N) fp32 mask too: per window-head
// as many bytes as q, k, v and out together at hd 32.
//
// Design: K5's tensor-core body (window_attn_nhwc_mma.cu, whose header
// says more) with the token-major layout policy of window_attn_mma.cuh:
// - mma.sync m16n8k16 for S = Q K^T and O = P V, the S accumulators re-used
//   as P's A fragment, V through ldmatrix.trans; one CTA of 4 warps per
//   (head, run of windows), 16 query rows a warp; the bias in registers at
//   the positions of the thread's S fragment, read once per CTA; 16-byte
//   cp.async double-buffered over the run; a base-2 softmax in registers.
//   A window-head's q, k, v and output are each one contiguous N x HD
//   block here; the output leaves through the warp's rows of the Q tile
//   (stmatrix) as 16-byte stores, as K6 writes its gradients.
// - Windows of fewer than 64 tokens are padded to 64 in shared memory only
//   (cp.async with source size 0 zero-fills rows t >= N): the bytes moved,
//   and the bound, stay those of N tokens. Padded keys get a bias of -inf
//   (p = 0); padded query rows are computed and not stored.
// - K4b compares region labels (3 ry + rx at rolled coordinates) only in
//   windows that hold more than one, as K5 does. K4a stages window w % nW's
//   mask with cp.async beside its q, k and v (so the next window's lands
//   while this one computes) and reads it at the fragment's positions; the
//   heads of one run sit on neighbouring CTAs (K5's grid), so a window's
//   mask comes from L2 after its first head. (Read straight into registers
//   per window instead, the loads sat on the critical path: 0.1757 ms at
//   the encoder's 104 x 104 level, 31% of the bound.)
// The JAX kernels' packing of two windows into one 128-row MXU tile is not
// carried over: it exists for the TPU's matrix unit.
//
// Numerics against the plain version: the logits are the fp32 sum q . k
// scaled afterwards (the plain version scales q first) and summed in the
// tensor cores' order; p = e * (1 / sum) with ex2.approx, rounded to bf16;
// out rounded once from fp32 (K5's rule and tolerance).

#include <stdint.h>

#include "window_attn_common.cuh"
#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kTile = 64;      // staged tokens per window: N <= 64, padded
constexpr int kStages = 2;     // windows in shared memory: 1 in use, 1 landing
constexpr float kLog2e = 1.4426950408889634f;

enum TokensMask { TOKENS_MASK_TENSOR = 0, TOKENS_MASK_LABELS = 1 };

// K4a's mask tile: rows of 72 floats, so that the 16 lanes of a half-warp
// reading float2 pairs at the fragment's positions hit 32 different banks
constexpr int kMaskPitch = kTile + 8;

template <int HD, int MASK>
struct Tile {
  static constexpr int kChunks = HD / 8;               // 16-byte pieces per row
  static constexpr int kPitch = HD * 2 + 16;           // staged row, bytes
  static constexpr int kTileBytes = kTile * kPitch;    // one operand
  static constexpr int kMaskBytes =
      MASK == TOKENS_MASK_TENSOR ? kTile * kMaskPitch * 4 : 0;
  static constexpr int kStageBytes = 3 * kTileBytes + kMaskBytes;  // q, k, v
  static constexpr int kSmem = kStages * kStageBytes + kTile;  // + labels
};

// Grid: K5's. nH * ceil(total_windows / windows_per_cta) CTAs; CTA x takes
// head x % nH and windows [(x / nH) * windows_per_cta, + windows_per_cta),
// the last run cut at total_windows (kernels/window_attention.py
// `tokens_fwd_cta_work` repeats this for the CPU tests). The mask variant
// stages a 64 x 72 fp32 mask tile beside q, k and v (18 KB per stage), so
// it fits 3 CTAs per SM instead of 4.
template <int HD, int MASK>
__global__ void __launch_bounds__(kThreads,
                                  MASK == TOKENS_MASK_LABELS ? 4 : 3)
    wa_tokens_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ rel,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, WaGeometry g,
                         int total_windows, int windows_per_cta) {
  using T = Tile<HD, MASK>;
  const TokensLayout lay{};
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* labs =
      reinterpret_cast<signed char*>(smem + kStages * T::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = g.N;
  const int h = blockIdx.x % g.nH;
  const int w0 = (blockIdx.x / g.nH) * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows - w0);
  // the thread's S fragment: rows r0, r1 = r0 + 8; columns 8 j + cb, + 1
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;
  const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses

  // rel[h] at the fragment's positions, times log2(e); -inf at padded keys,
  // 0 in padded query rows
  float bias[8][4];
  {
    const float* relh = rel + (int64_t)h * N * N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = 8 * j + cb + (e & 1);
        bias[j][e] = c >= N ? -INFINITY
                            : r < N ? relh[r * N + c] * kLog2e : 0.f;
      }
  }
  const float sl = g.scale * kLog2e;
  // K4a's mask rows go in 16-byte pieces where they are 16-byte aligned
  const bool mask16 = MASK == TOKENS_MASK_TENSOR && N % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(mask) & 15) == 0;

  // window w0 + i's q, k, v head slices into stage i % kStages (16 B each;
  // rows t >= N zero-filled) and, for K4a, its mask (rows r < N, columns
  // c < N; the rest of the tile is never read)
  auto load = [&](int i) {
    const int64_t o = lay.origin(g, w0 + i);
    unsigned char* st = smem + (i % kStages) * T::kStageBytes;
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const __nv_bfloat16* src = part == 0 ? q : part == 1 ? k : v;
#pragma unroll
      for (int it = 0; it < HD / 16; ++it) {
        const int c = tid + it * kThreads;
        const int t = c / T::kChunks, ch = c % T::kChunks;
        cp_async16_zfill(
            smem_addr(st + part * T::kTileBytes + t * T::kPitch + ch * 16),
            src + lay.in(g, o, h, min(t, N - 1)) + ch * 8, t < N ? 16 : 0);
      }
    }
    if (MASK == TOKENS_MASK_TENSOR) {
      const float* mw = mask + (int64_t)((w0 + i) % g.nW) * N * N;
      const uint32_t md = smem_addr(st + 3 * T::kTileBytes);
      if (mask16) {
        const int per_row = N >> 2;
        for (int c = tid; c < N * per_row; c += kThreads) {
          const int r = c / per_row, c4 = (c - r * per_row) * 4;
          cp_async16(md + (r * kMaskPitch + c4) * 4, mw + r * N + c4);
        }
      } else {
        for (int c = tid; c < N * N; c += kThreads) {
          const int r = c / N;
          cp_async4(md + (r * kMaskPitch + c - r * N) * 4, mw + c);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nwin) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nwin; ++i) {
    if (i + kStages - 1 < nwin) load(i + kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact
    const int w = w0 + i;
    const int wl = w % g.nW;
    int same = 1;
    if (MASK == TOKENS_MASK_LABELS && tid < kTile) {
      const int lab = tid < N ? wa_label(g, wl, tid) : -1;
      labs[tid] = static_cast<signed char>(lab);
      same = tid >= N || lab == wa_label(g, wl, 0);
    }
    cp_async_wait<kStages - 1>();  // window i has landed (this thread's)
    const int uniform = __syncthreads_and(same);  // ... everyone's, labels
    const uint32_t qs = smem_addr(smem + (i % kStages) * T::kStageBytes);
    const uint32_t ks = qs + T::kTileBytes, vs = ks + T::kTileBytes;

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[8][4];
    wa_qk_tile<HD>(s, qs, ks, T::kPitch, warp, lane);

    // logits in base 2: s * scale * log2(e) + (rel + mask) * log2(e), or
    // rel * log2(e) where the labels agree and -inf (p = 0) where they
    // differ; padded keys are -inf through the bias
    if (MASK == TOKENS_MASK_TENSOR) {
      // this window's mask at the fragment's positions (0 where padded)
      const float* ms = reinterpret_cast<const float*>(
          smem + (i % kStages) * T::kStageBytes + 3 * T::kTileBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + cb;
        const float2 a =
            *reinterpret_cast<const float2*>(ms + r0 * kMaskPitch + c);
        const float2 b =
            *reinterpret_cast<const float2*>(ms + r1 * kMaskPitch + c);
        const bool c0 = c < N, c1 = c + 1 < N;
        const bool q0 = r0 < N, q1 = r1 < N;
        s[j][0] = fmaf(s[j][0], sl,
                       fmaf(q0 && c0 ? a.x : 0.f, kLog2e, bias[j][0]));
        s[j][1] = fmaf(s[j][1], sl,
                       fmaf(q0 && c1 ? a.y : 0.f, kLog2e, bias[j][1]));
        s[j][2] = fmaf(s[j][2], sl,
                       fmaf(q1 && c0 ? b.x : 0.f, kLog2e, bias[j][2]));
        s[j][3] = fmaf(s[j][3], sl,
                       fmaf(q1 && c1 ? b.y : 0.f, kLog2e, bias[j][3]));
      }
    } else if (uniform) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = fmaf(s[j][e], sl, bias[j][e]);
    } else {
      const int l0 = labs[r0], l1 = labs[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = labs[8 * j + cb], c1 = labs[8 * j + cb + 1];
        s[j][0] = c0 == l0 ? fmaf(s[j][0], sl, bias[j][0]) : -INFINITY;
        s[j][1] = c1 == l0 ? fmaf(s[j][1], sl, bias[j][1]) : -INFINITY;
        s[j][2] = c0 == l1 ? fmaf(s[j][2], sl, bias[j][2]) : -INFINITY;
        s[j][3] = c1 == l1 ? fmaf(s[j][3], sl, bias[j][3]) : -INFINITY;
      }
    }
    // every stored row's max is finite: its diagonal key is real and agrees
    float i0, i1;
    wa_softmax_rows(s, i0, i1);

    // O = P V, P rounded to bf16
    float o[HD / 8][4];
    wa_pv_tile<HD>(o, s, i0, i1, vs, T::kPitch, lane);

    // this warp's 16 output rows through its own rows of the Q tile (read
    // into registers already), then 16-byte stores of the rows t < N: a
    // window-head's output is one contiguous N x HD block
    const uint32_t ot = qs + warp * 16 * T::kPitch;
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      const uint32_t r[4] = {pack_bf16(o[dn][0], o[dn][1]),
                             pack_bf16(o[dn][2], o[dn][3]),
                             pack_bf16(o[dn + 1][0], o[dn + 1][1]),
                             pack_bf16(o[dn + 1][2], o[dn + 1][3])};
      stsm_x4(ot + ((mi & 1) * 8 + (lane & 7)) * T::kPitch +
                  (dn * 8 + (mi >> 1) * 8) * 2,
              r);
    }
    __syncwarp();
    const unsigned char* otile =
        smem + (i % kStages) * T::kStageBytes + warp * 16 * T::kPitch;
    const int64_t org = lay.origin(g, w);
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int c = lane + it * 32;
      const int row = c / T::kChunks, ch = c % T::kChunks;
      if (warp * 16 + row < N)
        *reinterpret_cast<uint4*>(out + lay.out(g, org, h, warp * 16 + row) +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(otile + row * T::kPitch +
                                            ch * 16);
    }
    __syncthreads();  // stage i % kStages and the labels are free again
  }
}

template <int HD, int MASK>
int launch_hd(const void* q, const void* k, const void* v, const float* rel,
              const float* mask, void* out, const WaGeometry& g,
              int total_windows, int windows_per_cta, cudaStream_t stream) {
  auto kern = wa_tokens_mma_kernel<HD, MASK>;
  const int smem = Tile<HD, MASK>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (total_windows + windows_per_cta - 1) / windows_per_cta;
  kern<<<groups * g.nH, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel, mask,
      static_cast<__nv_bfloat16*>(out), g, total_windows, windows_per_cta);
  return (int)cudaGetLastError();
}

template <int MASK>
int launch(const void* q, const void* k, const void* v, const void* rel,
           const void* mask, void* out, const WaGeometry& g,
           int total_windows, int windows_per_cta, void* stream) {
  if (g.N < 1 || g.N > kTile || g.nH < 1 || g.nW < 1 || total_windows < 1 ||
      total_windows % g.nW || windows_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15 ||
      ((uintptr_t)rel | (uintptr_t)mask) & 3)
    return (int)cudaErrorMisalignedAddress;
  const float* r = static_cast<const float*>(rel);
  const float* m = static_cast<const float*>(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g.hd) {
    case 16:
      return launch_hd<16, MASK>(q, k, v, r, m, out, g, total_windows,
                                 windows_per_cta, st);
    case 32:
      return launch_hd<32, MASK>(q, k, v, r, m, out, g, total_windows,
                                 windows_per_cta, st);
    case 48:
      return launch_hd<48, MASK>(q, k, v, r, m, out, g, total_windows,
                                 windows_per_cta, st);
    case 64:
      return launch_hd<64, MASK>(q, k, v, r, m, out, g, total_windows,
                                 windows_per_cta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4a in bf16: q/k/v/out (total_windows, nH, N, hd); mask (nW, N, N) fp32
// added to window w's logits at w % nW; rel (nH, N, N) fp32. N <= 64, hd
// 16, 32, 48 or 64; q, k, v and out 16-byte aligned. windows_per_cta from
// the wrapper's plan. Returns cudaGetLastError() (0 = launched).
int window_attn_tokens_mma_mask(const void* q, const void* k, const void* v,
                                const void* rel, const void* mask, void* out,
                                int total_windows, int nW, int nH, int N,
                                int hd, int windows_per_cta, float scale,
                                void* stream) {
  const WaGeometry g = {nW, nH, N, hd, nH * hd, 0, 0, 1, 0, 0, 0, scale};
  return launch<TOKENS_MASK_TENSOR>(q, k, v, rel, mask, out, g,
                                    total_windows, windows_per_cta, stream);
}

// K4b in bf16: as K4a with the region labels of the (Hp, Wp, ws, shift)
// geometry instead of a mask tensor.
int window_attn_tokens_mma_geo(const void* q, const void* k, const void* v,
                               const void* rel, void* out, int total_windows,
                               int nH, int hd, int Hp, int Wp, int ws,
                               int shift, int windows_per_cta, float scale,
                               void* stream) {
  if (ws < 1 || Hp % ws || Wp % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  const WaGeometry g = {nW, nH, ws * ws, hd, nH * hd, Hp, Wp, ws, shift,
                        0, 0, scale};
  return launch<TOKENS_MASK_LABELS>(q, k, v, rel, nullptr, out, g,
                                    total_windows, windows_per_cta, stream);
}

const char* window_attn_tokens_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
