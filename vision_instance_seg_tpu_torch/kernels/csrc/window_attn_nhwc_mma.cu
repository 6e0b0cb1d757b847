// Window attention forward on the tensor cores (Hopper, sm_90a), bf16 only:
// K5 of vision_instance_seg_tpu/kernels/window_attention.py, `_wa_nhwc_impl`
// (:531) with its body `_wa_nhwc_kernel` (:442). Window partition,
// softmax(q . k^T * scale + rel, labels) . v and merge in one pass on NHWC
// maps: a fused (B, Hp, Wp, 3C) qkv map (Swin blocks) or split q, k, v maps
// (B, Hp, Wp, C) each (window encoder, with canvas-pad labels); windows of
// 8 x 8 (N = 64), head dim HD a multiple of 16 up to 64. fp32 calls take the
// SIMT body of window_attn_fwd.cu, which the parity checks hold bit-equal to
// the plain version.
//
// Bound: bytes. At Swin stage 1 in serving (qkv (8, 200, 200, 288) bf16)
// the call reads 184.3 MB and writes 61.4 MB: 245.8 MB, 73 us at 3.35 TB/s,
// against 7.9 GFLOP, 8 us on the tensor cores. So the design keeps every
// instruction off the bytes' path:
// - both products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate): S = Q K^T with K through ldmatrix ([key][d] rows are B's
//   column layout), O = P V with the S accumulators of n-tiles 2kk, 2kk + 1
//   re-used as P's A fragment of k-step kk (the FlashAttention-2 register
//   layout) and V through ldmatrix.trans;
// - one CTA of 4 warps per (head, run of windows), each warp owning 16 query
//   rows; the head's 64 x 64 fp32 bias is read once per CTA into registers,
//   at the positions of the thread's S fragment (32 values), instead of once
//   per window from L2;
// - q, k, v head slices staged as bf16 with 16-byte cp.async, rows padded
//   from HD * 2 to HD * 2 + 16 bytes so that ldmatrix has no bank
//   conflicts, double-buffered: window i + 1 loads while window i computes;
// - the softmax in registers (max and sum over the 4 lanes of a quad), in
//   base 2 with log2(e) folded into the scale and the bias; the labels are
//   compared only in windows that hold more than one label.
// The output leaves the accumulators as bf16 pairs: a quad writes 16
// contiguous bytes of a token's head slice. Nothing is atomic.
//
// Numerics against the plain version: the logits are the fp32 sum q . k
// scaled afterwards (the plain version scales q first) and summed in the
// tensor cores' order; p = e * (1 / sum) with ex2.approx, rounded to bf16;
// out rounded once from fp32. Each moves the output by far less than the one
// bf16 step of p and of out that the stated tolerance allows.
//
// Layout policy: `NhwcLayout` says where token t of window w and head h
// lives (pixel rows of `in_stride` elements, head slice at h * HD). A
// token-major policy ((w, h, t, :) rows, K4a and K4b) plugs in the same way.

#include <stdint.h>

#include "window_attn_common.cuh"
#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kN = 64;         // tokens per window (ws = 8)
constexpr int kMinBlocks = 4;  // CTAs per SM the registers must allow
constexpr int kStages = 2;     // windows in shared memory: 1 in use, 1 landing
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;               // 16-byte pieces per row
  static constexpr int kPitch = HD * 2 + 16;           // staged row, bytes
  static constexpr int kTileBytes = kN * kPitch;       // one operand
  static constexpr int kStageBytes = 3 * kTileBytes;   // q, k, v
  static constexpr int kSmem = kStages * kStageBytes + kN;  // + labels
};

// Grid: nH * ceil(total_windows / windows_per_cta) CTAs; CTA x takes head
// x % nH and windows [(x / nH) * windows_per_cta, + windows_per_cta), the
// last run cut at total_windows. The heads of one run sit on neighbouring
// CTAs, which the card runs together, so that whole pixel rows are read at
// about the same time (a grid that walked one head's windows after the
// other measured slower). (kernels/window_attention.py `nhwc_fwd_cta_work`
// repeats this arithmetic for the CPU tests.)
template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wa_nhwc_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ rel,
                       __nv_bfloat16* __restrict__ out, WaGeometry g,
                       Layout lay, int total_windows, int windows_per_cta) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* labs =
      reinterpret_cast<signed char*>(smem + kStages * T::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x % g.nH;
  const int w0 = (blockIdx.x / g.nH) * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows - w0);
  // the thread's S fragment: rows r0, r1 = r0 + 8; columns 8 j + cb, + 1
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;

  float bias[8][4];  // rel[h] at the fragment's positions, times log2(e)
  {
    const float* relh = rel + (int64_t)h * kN * kN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a =
          *reinterpret_cast<const float2*>(relh + r0 * kN + 8 * j + cb);
      const float2 b =
          *reinterpret_cast<const float2*>(relh + r1 * kN + 8 * j + cb);
      bias[j][0] = a.x * kLog2e;
      bias[j][1] = a.y * kLog2e;
      bias[j][2] = b.x * kLog2e;
      bias[j][3] = b.y * kLog2e;
    }
  }
  const float sl = g.scale * kLog2e;

  // window w0 + i's q, k, v head slices into stage i % kStages (16 B each)
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
        cp_async16(
            smem_addr(st + part * T::kTileBytes + t * T::kPitch + ch * 16),
            src + lay.in(g, o, h, t) + ch * 8);
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
    if (tid < kN) {
      const int lab = wa_label(g, wl, tid);
      labs[tid] = static_cast<signed char>(lab);
      same = lab == wa_label(g, wl, 0);
    }
    cp_async_wait<kStages - 1>();  // window i has landed (this thread's)
    const int uniform = __syncthreads_and(same);  // ... everyone's, labels
    const uint32_t qs = smem_addr(smem + (i % kStages) * T::kStageBytes);
    const uint32_t ks = qs + T::kTileBytes, vs = ks + T::kTileBytes;

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[8][4];
    wa_qk_tile<HD>(s, qs, ks, T::kPitch, warp, lane);

    // logits in base 2: s * scale * log2(e) + rel * log2(e) where the
    // labels agree, -inf (p = 0) where they differ; the diagonal always
    // agrees, so every row max is finite
    if (uniform) {
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
    float i0, i1;
    wa_softmax_rows(s, i0, i1);

    // O = P V, P rounded to bf16
    float o[HD / 8][4];
    wa_pv_tile<HD>(o, s, i0, i1, vs, T::kPitch, lane);

    // rows r0 and r1 of the output head slice, as bf16 pairs
    const int64_t org = lay.origin(g, w);
    __nv_bfloat16* d0 = out + lay.out(g, org, h, r0) + cb;
    __nv_bfloat16* d1 = out + lay.out(g, org, h, r1) + cb;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(d0 + dn * 8) = pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<uint32_t*>(d1 + dn * 8) = pack_bf16(o[dn][2], o[dn][3]);
    }
    __syncthreads();  // stage i % kStages and the labels are free again
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const float* rel,
           void* out, const WaGeometry& g, const NhwcLayout& lay,
           int total_windows, int windows_per_cta, cudaStream_t stream) {
  auto kern = wa_nhwc_mma_kernel<HD, NhwcLayout>;
  const int smem = Tile<HD>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (total_windows + windows_per_cta - 1) / windows_per_cta;
  kern<<<groups * g.nH, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel,
      static_cast<__nv_bfloat16*>(out), g, lay, total_windows,
      windows_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 in bf16: fused (q = the (B, Hp, Wp, 3C) qkv map; k and v ignored) or
// split q, k, v maps (B, Hp, Wp, C); rel (nH, 64, 64) fp32; out
// (B, Hp, Wp, C). Windows of 8; pad_h = pad_w = 0: no pad labels.
// windows_per_cta from the wrapper's plan. Every operand address must be
// 16-byte aligned, rel 8-byte and out 4-byte aligned. Returns
// cudaGetLastError() (0 = launched).
int window_attn_nhwc_mma(const void* q, const void* k, const void* v,
                         const void* rel, void* out, int fused, int B, int nH,
                         int C, int Hp, int Wp, int shift, int pad_h,
                         int pad_w, int windows_per_cta, float scale,
                         void* stream) {
  if (B < 1 || nH < 1 || C % nH || windows_per_cta < 1 || shift < 0 ||
      shift >= 8 || Hp < 8 || Wp < 8)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / 8) * (Wp / 8);
  const WaGeometry g = {nW, nH, kN, C / nH, C, Hp, Wp, 8, shift,
                        pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  const char* qb = static_cast<const char*>(q);
  const void* kp = fused ? qb + (size_t)C * 2 : k;
  const void* vp = fused ? qb + (size_t)C * 4 : v;
  if (((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp) & 15 ||
      (uintptr_t)rel & 7 || (uintptr_t)out & 3)
    return (int)cudaErrorMisalignedAddress;
  const NhwcLayout lay = {fused ? 3 * (int64_t)C : (int64_t)C, (int64_t)C};
  const int total = B * nW;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  switch (g.hd) {
    case 16:
      return launch<16>(q, kp, vp, r, out, g, lay, total, windows_per_cta, st);
    case 32:
      return launch<32>(q, kp, vp, r, out, g, lay, total, windows_per_cta, st);
    case 48:
      return launch<48>(q, kp, vp, r, out, g, lay, total, windows_per_cta, st);
    case 64:
      return launch<64>(q, kp, vp, r, out, g, lay, total, windows_per_cta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* window_attn_nhwc_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
