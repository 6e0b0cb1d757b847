// Window attention backward on the tensor cores (Hopper, sm_90a), bf16
// only: K6 of vision_instance_seg_tpu/kernels/window_attention.py,
// `_wa_nhwc_bwd_impl` (:696) with its body `_wa_nhwc_bwd_kernel` (:570),
// the recompute backward of K5 (window_attn_nhwc_mma.cu): nothing of the
// forward is saved but its operands. Per (window, head): S = Q K^T scale +
// rel where the labels agree, P = softmax(S), dP = G V^T,
// dS = P (dP - rowsum(dP P)), dQ = dS K scale, dK = dS^T Q scale,
// dV = P^T G; d(rel) (nH, 64, 64) fp32 is dS summed over every window of
// every image. Fused (one (B, Hp, Wp, 3C) qkv map -> one dqkv map) or split
// ((B, Hp, Wp, C) q, k, v -> dq, dk, dv, with canvas-pad labels); windows
// of 8 x 8 (N = 64), head dim HD a multiple of 16 up to 64. fp32 calls take
// the SIMT body of window_attn_bwd.cu.
//
// Bound: bytes. At Swin stage 1 in training (qkv (2, 160, 160, 288) bf16)
// the call reads 29.5 MB of qkv and 9.8 MB of g and writes 29.5 MB of
// dqkv: 68.8 MB, 21 us at 3.35 TB/s, against 3.1 GFLOP in five products,
// 3 us on the tensor cores. The design:
// - all five products on mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//   K5's grid: one CTA of 4 warps per (head, run of windows), the heads of
//   one run on neighbouring CTAs;
// - query-row pass, each warp 16 query rows: S = Q K^T and dP = G V^T with
//   K and V through ldmatrix ([key][d] rows are B's column layout); the
//   bias, the labels and the softmax as in K5, in fp32 registers;
//   rs = rowsum(dP P) over the quad; dS = P (dP - rs), exactly 0 where
//   P is; dQ = dS K with dS's accumulators re-used as A fragments (the
//   FlashAttention-2 register layout, as K5 re-uses P) and K through
//   ldmatrix.trans;
// - key-row pass: dV and dK sum over the query rows of all four warps, so
//   P and dS go to shared memory as bf16 tiles through stmatrix (rows
//   padded from 128 to 144 bytes); each warp then takes 16 key rows, P^T
//   and dS^T as A through ldmatrix.trans, G and Q as B through
//   ldmatrix.trans;
// - q, k, v and g head slices staged as bf16 by 16-byte cp.async, rows
//   padded from HD * 2 to HD * 2 + 16 bytes (no ldmatrix bank conflicts),
//   kStages windows in flight over the run: window i + kStages - 1 loads
//   while i computes, its copy issued after window i's first barrier, when
//   every warp is done with window i - 1, so two barriers per window
//   suffice;
// - the head's bias (times log2 e) read once per CTA into shared memory,
//   laid out by thread so that each thread reads its S fragment's 32
//   values as 8 conflict-free 16-byte loads (in registers, beside S, dP
//   and the d(rel) sums, they would take 32 more per thread: head dim 64
//   uses 242 of 255 already);
// - d(rel) without atomics: the S fragments of the 128 threads cover the
//   64 x 64 tile once, so each thread adds its fp32 dS into 32 registers,
//   window after window in order, and writes them once per CTA as its
//   run's partial; wa_drel_sum adds the runs in a fixed order, so d(rel)
//   repeats bit for bit. The partials (16 KB per CTA, written and read back once)
//   are not in the bound: `nhwc_bwd_plan` keeps at least 3 windows per
//   CTA, under a fifth of the call's bytes at head dim 32.
// - gradients leave the accumulators through a per-warp bf16 tile
//   (stmatrix) as 16-byte stores, four lanes to a token's head slice:
//   storing the fragments' 4-byte pairs directly took 23% longer at Swin
//   stage 1 on an H100 (scripts/bench_k6.py), since every such store
//   touches 8 token rows for 16 bytes each.
// Nothing is atomic; two CTAs per SM (registers).
//
// Numerics against the plain version: P and dS are rounded to bf16 before
// the products dV, dQ and dK (as the backward of FlashAttention-2 and of
// SDPA do), with fp32 accumulation; rs and d(rel) come from fp32 P and dS.
// The logits and the softmax are K5's (base 2, ex2.approx).

#include <stdint.h>

#include "window_attn_common.cuh"
#include "window_attn_drel.cuh"
#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;         // 4 warps x 16 query, then key, rows
constexpr int kN = 64;                // tokens per window (ws = 8)
constexpr int kMinBlocks = 2;         // CTAs per SM the registers must allow
constexpr int kStages = 2;            // windows in shared memory
constexpr int kSPitch = kN * 2 + 16;  // a bf16 P or dS tile's row, bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct BwdTile {
  static constexpr int kChunks = HD / 8;               // 16-byte pieces per row
  static constexpr int kPitch = HD * 2 + 16;           // staged row, bytes
  static constexpr int kTileBytes = kN * kPitch;       // one operand
  static constexpr int kStageBytes = 4 * kTileBytes;   // q, k, v, g
  static constexpr int kBiasBytes = kN * kN * 4;       // fp32
  static constexpr int kScoreBytes = kN * kSPitch;     // P or dS
  static constexpr int kOutBytes = 16 * kPitch;        // a warp's 16 rows out
  static constexpr int kSmem = kBiasBytes + kStages * kStageBytes +
                               2 * kScoreBytes + 4 * kOutBytes + kN;  // + labels
};

// Grid: K5's (kernels/window_attention.py `nhwc_bwd_cta_work` repeats it
// for the CPU tests): nH * ceil(total_windows / windows_per_cta) CTAs; CTA
// x takes head x % nH and windows [(x / nH) * windows_per_cta,
// + windows_per_cta), the last run cut at total_windows, and writes its
// d(rel) partial to row x of partial ((groups * nH) x 64 x 64).
template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wa_nhwc_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ gout,
                           const float* __restrict__ rel,
                           __nv_bfloat16* __restrict__ dq,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           float* __restrict__ partial, WaGeometry g,
                           Layout lay, int total_windows,
                           int windows_per_cta) {
  using T = BwdTile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bias = reinterpret_cast<float4*>(smem);
  unsigned char* stages = smem + T::kBiasBytes;
  unsigned char* ptile = stages + kStages * T::kStageBytes;
  unsigned char* dstile = ptile + T::kScoreBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* otile = dstile + T::kScoreBytes + warp * T::kOutBytes;
  signed char* labs =
      reinterpret_cast<signed char*>(dstile + T::kScoreBytes + 4 * T::kOutBytes);
  const int h = blockIdx.x % g.nH;
  const int w0 = (blockIdx.x / g.nH) * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows - w0);
  // the thread's S fragment: rows r0, r1 = r0 + 8; columns 8 j + cb, + 1.
  // In the key-row pass r0 and r1 name the accumulators' key rows.
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;
  const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses

  // window w0 + i's q, k, v and g head slices into stage i % kStages
  auto load = [&](int i) {
    const int64_t o = lay.origin(g, w0 + i);
    unsigned char* st = stages + (i % kStages) * T::kStageBytes;
#pragma unroll
    for (int part = 0; part < 4; ++part) {
      const __nv_bfloat16* src =
          part == 0 ? q : part == 1 ? k : part == 2 ? v : gout;
#pragma unroll
      for (int it = 0; it < HD / 16; ++it) {
        const int c = tid + it * kThreads;
        const int t = c / T::kChunks, ch = c % T::kChunks;
        const int64_t at = part == 3 ? lay.out(g, o, h, t) : lay.in(g, o, h, t);
        cp_async16(
            smem_addr(st + part * T::kTileBytes + t * T::kPitch + ch * 16),
            src + at + ch * 8);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // land while the bias is read
    if (i < nwin) load(i);
    cp_async_commit();
  }
  {
    // rel[h] at the fragment's positions, times log2(e); each thread reads
    // back only what it wrote, so no barrier is needed
    const float* relh = rel + (int64_t)h * kN * kN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a =
          *reinterpret_cast<const float2*>(relh + r0 * kN + 8 * j + cb);
      const float2 b =
          *reinterpret_cast<const float2*>(relh + r1 * kN + 8 * j + cb);
      bias[j * kThreads + tid] = make_float4(a.x * kLog2e, a.y * kLog2e,
                                             b.x * kLog2e, b.y * kLog2e);
    }
  }
  // rows warp * 16 .. + 15 of a gradient's head slice (a 16 x HD
  // accumulator, times sc) through this warp's tile, as 16-byte stores
  auto store_rows = [&](const float(&o)[HD / 8][4], float sc,
                        __nv_bfloat16* dst, int64_t org) {
    const uint32_t ot = smem_addr(otile);
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      const uint32_t r[4] = {pack_bf16(o[dn][0] * sc, o[dn][1] * sc),
                             pack_bf16(o[dn][2] * sc, o[dn][3] * sc),
                             pack_bf16(o[dn + 1][0] * sc, o[dn + 1][1] * sc),
                             pack_bf16(o[dn + 1][2] * sc, o[dn + 1][3] * sc)};
      stsm_x4(ot + ((mi & 1) * 8 + (lane & 7)) * T::kPitch +
                  (dn * 8 + (mi >> 1) * 8) * 2,
              r);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int c = lane + it * 32;
      const int row = c / T::kChunks, ch = c % T::kChunks;
      *reinterpret_cast<uint4*>(dst + lay.in(g, org, h, warp * 16 + row) +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(otile + row * T::kPitch + ch * 16);
    }
    __syncwarp();  // the tile is free again
  };

  const float sl = g.scale * kLog2e;
  float acc[8][4];  // d(rel) at the fragment's positions, over the run
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < nwin; ++i) {
    const int w = w0 + i;
    const int wl = w % g.nW;
    int same = 1;
    if (tid < kN) {
      const int lab = wa_label(g, wl, tid);
      labs[tid] = static_cast<signed char>(lab);
      same = lab == wa_label(g, wl, 0);
    }
    cp_async_wait<kStages - 2>();  // window i has landed (this thread's)
    // ... everyone's, and the labels; every warp is done with window i - 1
    const int uniform = __syncthreads_and(same);
    if (i + kStages - 1 < nwin) load(i + kStages - 1);  // window i - 1's stage
    cp_async_commit();  // possibly empty: keeps the wait count exact
    const uint32_t qs = smem_addr(stages + (i % kStages) * T::kStageBytes);
    const uint32_t ks = qs + T::kTileBytes, vs = ks + T::kTileBytes,
                   gs = vs + T::kTileBytes;

    // S = Q K^T, then dP = G V^T: this warp's 16 query rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // d += A B^T: A's 16 rows of this warp, B's 64 [key][d] rows
    auto rows_by_keys = [&](float(&d)[8][4], uint32_t as, uint32_t bs) {
      uint32_t a[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(a[kk], as + (warp * 16 + (mi & 1) * 8 + (lane & 7)) *
                                T::kPitch +
                           (kk * 16 + (mi >> 1) * 8) * 2);
#pragma unroll
      for (int j = 0; j < 8; j += 2)  // n-tiles j, j + 1 per ldmatrix
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, bs + (8 * (j + (mi >> 1)) + (lane & 7)) * T::kPitch +
                         (kk * 16 + (mi & 1) * 8) * 2);
          mma_bf16(d[j], a[kk], b[0], b[1]);
          mma_bf16(d[j + 1], a[kk], b[2], b[3]);
        }
    };
    rows_by_keys(s, qs, ks);
    rows_by_keys(dp, gs, vs);

    // logits in base 2, as K5: s * scale * log2(e) + rel * log2(e) where
    // the labels agree, -inf (P = 0) where they differ
    if (uniform) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = bias[j * kThreads + tid];
        s[j][0] = fmaf(s[j][0], sl, b.x);
        s[j][1] = fmaf(s[j][1], sl, b.y);
        s[j][2] = fmaf(s[j][2], sl, b.z);
        s[j][3] = fmaf(s[j][3], sl, b.w);
      }
    } else {
      const int l0 = labs[r0], l1 = labs[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = bias[j * kThreads + tid];
        const int c0 = labs[8 * j + cb], c1 = labs[8 * j + cb + 1];
        s[j][0] = c0 == l0 ? fmaf(s[j][0], sl, b.x) : -INFINITY;
        s[j][1] = c1 == l0 ? fmaf(s[j][1], sl, b.y) : -INFINITY;
        s[j][2] = c0 == l1 ? fmaf(s[j][2], sl, b.z) : -INFINITY;
        s[j][3] = c1 == l1 ? fmaf(s[j][3], sl, b.w) : -INFINITY;
      }
    }
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
    const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);

    // P in fp32, and rs = rowsum(dP P)
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] *= i0;
      s[j][1] *= i0;
      s[j][2] *= i1;
      s[j][3] *= i1;
      rs0 += dp[j][0] * s[j][0] + dp[j][1] * s[j][1];
      rs1 += dp[j][2] * s[j][2] + dp[j][3] * s[j][3];
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);

    // dS = P (dP - rs): into d(rel) in fp32; P and dS in bf16 as A
    // fragments (n-tiles 2kk, 2kk + 1 make k-step kk: dQ's operand) and,
    // through stmatrix, into the tiles
    uint32_t da[4][4];
    {
      const uint32_t at = (warp * 16 + (mi & 1) * 8 + (lane & 7)) * kSPitch +
                          (mi >> 1) * 16;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          const float d0 = s[j][0] * (dp[j][0] - rs0);
          const float d1 = s[j][1] * (dp[j][1] - rs0);
          const float d2 = s[j][2] * (dp[j][2] - rs1);
          const float d3 = s[j][3] * (dp[j][3] - rs1);
          acc[j][0] += d0;
          acc[j][1] += d1;
          acc[j][2] += d2;
          acc[j][3] += d3;
          da[kk][2 * jj] = pack_bf16(d0, d1);
          da[kk][2 * jj + 1] = pack_bf16(d2, d3);
          pa[2 * jj] = pack_bf16(s[j][0], s[j][1]);
          pa[2 * jj + 1] = pack_bf16(s[j][2], s[j][3]);
        }
        stsm_x4(smem_addr(ptile) + at + kk * 32, pa);
        stsm_x4(smem_addr(dstile) + at + kk * 32, da[kk]);
      }
    }

    // dQ = dS K scale: K [key][d] through .trans
    const int64_t org = lay.origin(g, w);
    {
      float o[HD / 8][4];
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, ks + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                     T::kPitch +
                                (dn * 8 + (mi >> 1) * 8) * 2);
          mma_bf16(o[dn], da[kk], kb[0], kb[1]);
          mma_bf16(o[dn + 1], da[kk], kb[2], kb[3]);
        }
      store_rows(o, g.scale, dq, org);
    }
    __syncthreads();  // the P and dS tiles are whole

    // dV = P^T G and dK = dS^T Q scale: this warp's 16 key rows; k-step kk
    // sums query rows kk * 16 .. + 15
    {
      float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[dn][e] = ak[dn][e] = 0.f;
      const uint32_t ps = smem_addr(ptile), dss = smem_addr(dstile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t at = (kk * 16 + (mi >> 1) * 8 + (lane & 7)) * kSPitch +
                            (warp * 16 + (mi & 1) * 8) * 2;
        uint32_t pa[4], sa[4];
        ldsm_x4_trans(pa, ps + at);
        ldsm_x4_trans(sa, dss + at);
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          const uint32_t bt = (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                  T::kPitch +
                              (dn * 8 + (mi >> 1) * 8) * 2;
          uint32_t b[4];
          ldsm_x4_trans(b, gs + bt);
          mma_bf16(av[dn], pa, b[0], b[1]);
          mma_bf16(av[dn + 1], pa, b[2], b[3]);
          ldsm_x4_trans(b, qs + bt);
          mma_bf16(ak[dn], sa, b[0], b[1]);
          mma_bf16(ak[dn + 1], sa, b[2], b[3]);
        }
      }
      store_rows(av, 1.f, dv, org);
      store_rows(ak, g.scale, dk, org);
    }
  }

  // the run's d(rel) partial
  float* part = partial + (int64_t)blockIdx.x * kN * kN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(part + r0 * kN + 8 * j + cb) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(part + r1 * kN + 8 * j + cb) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* gout,
           const float* rel, void* dq, void* dk, void* dv, float* partial,
           float* drel, const WaGeometry& g, const NhwcLayout& lay,
           int total_windows, int windows_per_cta, cudaStream_t stream) {
  auto kern = wa_nhwc_bwd_mma_kernel<HD, NhwcLayout>;
  const int smem = BwdTile<HD>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  using B16 = __nv_bfloat16;
  const int groups = (total_windows + windows_per_cta - 1) / windows_per_cta;
  kern<<<groups * g.nH, kThreads, smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<const B16*>(gout), rel,
      static_cast<B16*>(dq), static_cast<B16*>(dk), static_cast<B16*>(dv),
      partial, g, lay, total_windows, windows_per_cta);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return wa_drel_sum(partial, drel, groups, g.nH * kN * kN, stream);
}

}  // namespace

extern "C" {

// K6 in bf16: fused (q = the (B, Hp, Wp, 3C) qkv map and dq = the dqkv map;
// k, v, dk, dv ignored) or split q, k, v and dq, dk, dv maps (B, Hp, Wp, C);
// gout (B, Hp, Wp, C) bf16; rel (nH, 64, 64) fp32. partial holds
// nH * ceil(B * nW / windows_per_cta) x 64 x 64 floats (windows_per_cta
// from the wrapper's plan), drel nH x 64 x 64. Windows of 8; pad_h =
// pad_w = 0: no pad labels. The operands, gout and the gradients must be
// 16-byte aligned, rel and partial 8-byte. Returns cudaGetLastError()
// (0 = launched).
int window_attn_nhwc_bwd_mma(const void* q, const void* k, const void* v,
                             const void* gout, const void* rel, void* dq,
                             void* dk, void* dv, void* partial, void* drel,
                             int fused, int B, int nH, int C, int Hp, int Wp,
                             int shift, int pad_h, int pad_w,
                             int windows_per_cta, float scale, void* stream) {
  if (B < 1 || nH < 1 || C % nH || windows_per_cta < 1 || shift < 0 ||
      shift >= 8 || Hp < 8 || Wp < 8)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / 8) * (Wp / 8);
  const WaGeometry g = {nW, nH, kN, C / nH, C, Hp, Wp, 8, shift,
                        pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  const char* qb = static_cast<const char*>(q);
  char* db = static_cast<char*>(dq);
  const void* kp = fused ? qb + (size_t)C * 2 : k;
  const void* vp = fused ? qb + (size_t)C * 4 : v;
  void* dkp = fused ? db + (size_t)C * 2 : dk;
  void* dvp = fused ? db + (size_t)C * 4 : dv;
  if (((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)gout |
       (uintptr_t)dq | (uintptr_t)dkp | (uintptr_t)dvp) & 15 ||
      ((uintptr_t)rel | (uintptr_t)partial) & 7)
    return (int)cudaErrorMisalignedAddress;
  const NhwcLayout lay = {fused ? 3 * (int64_t)C : (int64_t)C, (int64_t)C};
  const int total = B * nW;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* pp = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  switch (g.hd) {
    case 16:
      return launch<16>(q, kp, vp, gout, r, dq, dkp, dvp, pp, dr, g, lay,
                        total, windows_per_cta, st);
    case 32:
      return launch<32>(q, kp, vp, gout, r, dq, dkp, dvp, pp, dr, g, lay,
                        total, windows_per_cta, st);
    case 48:
      return launch<48>(q, kp, vp, gout, r, dq, dkp, dvp, pp, dr, g, lay,
                        total, windows_per_cta, st);
    case 64:
      return launch<64>(q, kp, vp, gout, r, dq, dkp, dvp, pp, dr, g, lay,
                        total, windows_per_cta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* window_attn_nhwc_bwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
