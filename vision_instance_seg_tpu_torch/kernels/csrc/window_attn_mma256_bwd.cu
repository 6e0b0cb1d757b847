// Window attention backward over windows of 16 x 16 (N = 256 tokens) on
// the tensor cores (Hopper, sm_90a), bf16 only: K6 of
// vision_instance_seg_tpu/kernels/window_attention.py, `_wa_nhwc_bwd_impl`
// (:696) with its body `_wa_nhwc_bwd_kernel` (:570), at the window-16
// encoder's windows. The recompute backward of K5 (window_attn_mma256.cu):
// per (window, head), S = Q K^T scale + rel[h] where the labels agree (-1e9,
// here -inf, where they differ), P = softmax(S), dP = G V^T,
// rs = rowsum(dP P), dS = P (dP - rs), dQ = dS K scale, dK = dS^T Q scale,
// dV = P^T G; d(rel) (nH, 256, 256) fp32 is dS summed over every window.
// Fused (one (B, Hp, Wp, 3C) qkv map -> one dqkv map) or split ((B, Hp,
// Wp, C) q, k, v -> dq, dk, dv, with canvas-pad labels); head dim HD a
// multiple of 16 up to 64. fp32, and bf16 head dims that are not multiples
// of 16, take the SIMT body of window_attn_bwd.cu; windows of 8 x 8 the
// 64-token body of window_attn_nhwc_bwd_mma.cu (kernels/window_attention.py
// `nhwc_bwd_body`).
//
// Bound. At the window-16 encoder's finest level in training ((2, 80, 80,
// 256) split, 8 heads x 32, 50 windows, 400 window-heads) the call reads
// q, k, v and g (26.2 MB) and rel (2.1 MB) and writes dq, dk, dv (19.7
// MB) and d(rel) (2.1 MB): 50.1 MB, 14.9 us at 3.35 TB/s. The five
// products are 2 N^2 HD flops each per window-head, 21.0 GFLOP for the
// call, 10.6 us on the tensor cores; this design issues nine (S and dP
// twice in kernel A, once more in kernel B, dQ, dK and dV), 15.1 GFLOP,
// 15.3 us. It takes 2 N^2 ex2 per window-head in kernel A and N^2 in
// kernel B, 78.6 M for the call: at 16 per clock per SM (132 SMs,
// ~1.98 GHz, ~4.2e12/s) ~19 us. So the byte bound, the products and the
// ex2 are all near 15-19 us; none of them sets this body's pace (see
// PERF.md for the measured time).
//
// Design. No CTA can hold a whole window-head's S at 256 tokens as the
// 64-token body does, and nothing may be atomic (d(rel) repeats bit for
// bit). So FlashAttention-2's backward, split by query block and by key
// block, in two kernels:
// - Kernel A (`wa_mma256_bwd_rows_kernel`): row statistics, dQ, d(rel).
//   The forward's grid: one CTA of 4 warps per (64-row query block, head,
//   run of windows), each warp 16 query rows, the CTA's 64 x 256 bias
//   slice in shared memory for the whole run. Per window, two loops over
//   the 4 key blocks of 64, each S = bias + Q K^T and dP = G V^T on
//   mma.sync m16n8k16 (Q and G rows as A fragments, loaded once per
//   window; K and V [key][d] rows through ldmatrix). Loop 1 keeps the
//   online softmax's running max m and sum l and a third running sum
//   r = sum exp2(s - m) dP under the same rescale, so rs = r / l is exact
//   in fp32 (not rowsum(G O) from an O that carries P in bf16). It writes
//   each row's lse = m + log2 l (base 2) and rs to two fp32 scratch arrays
//   (total windows, nH, 256) for kernel B. Loop 2: P = exp2(s - lse),
//   dS = P (dP - rs); dQ += dS K with dS's accumulators re-used as A
//   fragments and K through ldmatrix.trans; d(rel) += dS into the CTA's
//   64 x 256 fp32 slice in shared memory, laid out by thread like the bias
//   (each thread read-modify-writes only its own cells: no barrier, no
//   bank conflict). dQ leaves once per window through a per-warp bf16
//   tile (stmatrix) as 16-byte stores. At the end of its run the CTA
//   writes its slice as rows qb * 64 .. of head h of its group's partial
//   ((groups, nH, N, N)); wa_drel_sum (window_attn_drel.cuh) adds the
//   groups in a fixed order.
// - Kernel B (`wa_mma256_bwd_cols_kernel`): dK and dV. One CTA of 4 warps
//   per (64-row key block, head, run of windows), each warp 16 key rows,
//   so that dK and dV sum in registers over the 4 query blocks: the
//   transposed form, S^T = K Q^T + bias^T and dP^T = V G^T (K and V rows as
//   A fragments once per window, the query block's Q and G rows through
//   ldmatrix), P^T = exp2(s^T - lse_i), dS^T = P^T (dP^T - rs_i) with lse
//   and rs staged per query block from kernel A's scratch; dV += P^T G and
//   dK += dS^T Q, P^T and dS^T from the accumulators as A fragments, G and
//   Q through ldmatrix.trans. The CTA's 256 x 64 slice of rel[h]^T sits in
//   shared memory by thread, once per CTA.
// - Both kernels stage the operands as bf16 by 16-byte cp.async, rows
//   padded from HD * 2 to HD * 2 + 16 bytes, through a ring of kStages
//   steps, one barrier per step. A step's blocks (K and V in A, Q, G and
//   the statistics in B) go into the ring; the rows a CTA keeps for a
//   whole window (Q and G in A, K and V in B) go into one buffer that the
//   window's first step fills and reads into registers: the next window's
//   copy is issued kStages - 1 steps ahead, after every warp is past that
//   first step.
// - Labels per window in shared memory, double-buffered, compared only in
//   windows that hold more than one; the excluded logits start at -inf,
//   so P and dS are exactly 0 there.
// - The partials: `mma256_bwd_plan` keeps them (nH x 256 x 256 fp32, 2 MB
//   at 8 heads, per group) under a fifth of the call's bytes, so runs are
//   few and long: 4 groups at the finest level above (128 kernel-A CTAs,
//   about one wave at the 1 CTA per SM that A's shared memory allows), 1
//   on the coarser levels. Kernel B writes no partial and takes its own,
//   shorter runs.
// Shared memory per CTA (kStages 3): A 2 x 64 KB (bias, d(rel)), Q and G
// rows, 3 K/V stages, 4 warp tiles, labels: HD 16 159,232 B, 32 177,664,
// 48 196,096, 64 214,528 (1 CTA per SM); B 64 KB bias^T, K and V rows, 3
// Q/G/statistics stages, warp tiles, labels: HD 16 95,232, 32 113,664 (2
// CTAs per SM), 48 132,096, 64 150,528 (1).
//
// Numerics against the plain version: P and dS are rounded to bf16 before
// the products dV, dQ and dK (as FlashAttention-2's and SDPA's backward
// do), with fp32 accumulation; rs and d(rel) come from fp32 P and dS. The
// logits and the softmax are K5's (base 2, ex2.approx), P normalized by
// the row's lse before it is rounded.

#include <stdint.h>

#include "window_attn_common.cuh"
#include "window_attn_drel.cuh"
#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps x 16 rows
constexpr int kN = 256;                // tokens per window (16 x 16)
constexpr int kWs = 16;
constexpr int kBlock = 64;             // rows per CTA; columns per step
constexpr int kBlocks = kN / kBlock;   // query blocks, key blocks
constexpr int kStages = 3;             // steps in the copy ring
constexpr int kFrags = kBlocks * 8;    // a thread's float4s of a 64 x 256
                                       // slice
constexpr int kSliceBytes = kFrags * kThreads * 16;  // 64 KB
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Bwd256Tile {
  static constexpr int kPitch = HD * 2 + 16;           // staged row, bytes
  static constexpr int kTileBytes = kBlock * kPitch;   // 64 rows
  static constexpr int kOutBytes = 16 * kPitch;        // a warp's 16 rows out
  static constexpr int kStatBytes = 2 * kBlock * 4;    // lse, rs of 64 rows
  static constexpr int kStageA = 2 * kTileBytes;       // K, V blocks
  static constexpr int kStageB = 2 * kTileBytes + kStatBytes;  // Q, G, stats
  static constexpr int kSmemA = 2 * kSliceBytes + 2 * kTileBytes +
                                kStages * kStageA + 4 * kOutBytes + 2 * kN;
  static constexpr int kSmemB = kSliceBytes + 2 * kTileBytes +
                                kStages * kStageB + 4 * kOutBytes + 2 * kN;
  static_assert(kSmemA <= WA_MAX_SMEM && kSmemB <= WA_MAX_SMEM,
                "shared memory");
};

// The thread's 16-byte pieces of a 64-row head-slice block: pieces c = tid
// + 128 it, at row c / (HD / 8), piece c % (HD / 8). Token t0 + t of a
// block that starts at token t0 (a multiple of 16) sits lay.in(g, 0, 0, t)
// (operands) or lay.out(g, 0, 0, t) (the cotangent) elements past token t0.
template <int HD>
struct BlockCopy {
  static constexpr int kChunks = HD / 8;
  int64_t gin[HD / 16], gout[HD / 16];
  int soff[HD / 16];

  template <class Layout>
  __device__ __forceinline__ BlockCopy(const WaGeometry& g, const Layout& lay,
                                       int tid) {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int c = tid + it * kThreads;
      const int t = c / kChunks, ch = c % kChunks;
      gin[it] = lay.in(g, 0, 0, t) + ch * 8;
      gout[it] = lay.out(g, 0, 0, t) + ch * 8;
      soff[it] = t * Bwd256Tile<HD>::kPitch + ch * 16;
    }
  }
  // a block of an operand (q, k, v) starting at src into the tile at dst
  __device__ __forceinline__ void in(uint32_t dst,
                                     const __nv_bfloat16* src) const {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it)
      cp_async16(dst + soff[it], src + gin[it]);
  }
  // ... of the cotangent
  __device__ __forceinline__ void out(uint32_t dst,
                                      const __nv_bfloat16* src) const {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it)
      cp_async16(dst + soff[it], src + gout[it]);
  }
};

// window w's labels into lw (256 of them); returns whether the thread's
// tokens all share token 0's label
__device__ __forceinline__ int window_labels(const WaGeometry& g, int w,
                                             signed char* lw, int tid) {
  const int wl = w % g.nW, ww = g.Wp / kWs;
  const int y0 = (wl / ww) * kWs, x0 = (wl % ww) * kWs;
  const int lab0 = wa_label_at(g, y0, x0);
  int same = 1;
#pragma unroll
  for (int t = tid; t < kN; t += kThreads) {
    const int lab = wa_label_at(g, y0 + (t >> 4), x0 + (t & 15));
    lw[t] = static_cast<signed char>(lab);
    same &= lab == lab0;
  }
  return same;
}

// rows t0 + warp * 16 .. + 15 of a gradient's head slice (a 16 x HD
// accumulator, times sc) through the warp's tile, as 16-byte stores
template <int HD, class Layout>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 8][4],
                                           float sc, __nv_bfloat16* dst,
                                           const WaGeometry& g,
                                           const Layout& lay, int64_t org,
                                           int h, int t0,
                                           unsigned char* otile, int lane) {
  constexpr int kPitch = Bwd256Tile<HD>::kPitch, kChunks = HD / 8;
  const int mi = lane >> 3;
  const uint32_t ot = smem_addr(otile);
#pragma unroll
  for (int dn = 0; dn < HD / 8; dn += 2) {
    const uint32_t r[4] = {pack_bf16(o[dn][0] * sc, o[dn][1] * sc),
                           pack_bf16(o[dn][2] * sc, o[dn][3] * sc),
                           pack_bf16(o[dn + 1][0] * sc, o[dn + 1][1] * sc),
                           pack_bf16(o[dn + 1][2] * sc, o[dn + 1][3] * sc)};
    stsm_x4(ot + ((mi & 1) * 8 + (lane & 7)) * kPitch +
                (dn * 8 + (mi >> 1) * 8) * 2,
            r);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < HD / 16; ++it) {
    const int c = lane + it * 32;
    const int row = c / kChunks, ch = c % kChunks;
    *reinterpret_cast<uint4*>(dst + lay.in(g, org, h, t0 + row) + ch * 8) =
        *reinterpret_cast<const uint4*>(otile + row * kPitch + ch * 16);
  }
  __syncwarp();  // the tile is free again
}

// Grids (kernels/window_attention.py `mma256_bwd_cta_work` repeats them
// for the CPU tests): 4 * nH * ceil(total_windows / windows_per_cta) CTAs;
// CTA x takes block x % 4 (kernel A: query block, B: key block), head
// (x / 4) % nH and windows [grp * windows_per_cta, + windows_per_cta) with
// grp = x / (4 nH), the last run cut at total_windows. Kernel A's group
// grp writes rows (x % 4) * 64 .. + 63 of partial[grp][h].

// Kernel A: row statistics, dQ and d(rel).
template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, 1)
    wa_mma256_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ gout,
                              const float* __restrict__ rel,
                              __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ lse,
                              float* __restrict__ rsum,
                              float* __restrict__ partial, WaGeometry g,
                              Layout lay, int total_windows,
                              int windows_per_cta) {
  using T = Bwd256Tile<HD>;
  constexpr int kSteps = 2 * kBlocks;  // a window: statistics, gradients
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bias = reinterpret_cast<float4*>(smem);
  float4* drel = bias + kFrags * kThreads;
  unsigned char* rows = smem + 2 * kSliceBytes;  // the window's Q, G rows
  unsigned char* stages = rows + 2 * T::kTileBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* otile = stages + kStages * T::kStageA + warp * T::kOutBytes;
  signed char* labs = reinterpret_cast<signed char*>(
      stages + kStages * T::kStageA + 4 * T::kOutBytes);
  const int qb = blockIdx.x % kBlocks;
  const int h = (blockIdx.x / kBlocks) % g.nH;
  const int grp = (blockIdx.x / kBlocks) / g.nH;
  const int w0 = grp * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows - w0);
  const int nsteps = nwin * kSteps;
  const int q0 = qb * kBlock;  // the CTA's first query token
  // the thread's S fragment: rows r0, r1 = r0 + 8 of the query block;
  // columns 8 j + cb, + 1 of the key block
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;
  const int mi = lane >> 3;

  const BlockCopy<HD> cp(g, lay, tid);
  // step s = (window s / 8, loop (s / 4) % 2, key block s % 4) into stage
  // s % kStages: the key block's K and V rows and, in a window's first
  // step, its Q and G rows of the query block
  int64_t load_org = 0;
  auto load = [&](int s) {
    const int kb = s % kBlocks;
    if (s % kSteps == 0) {
      load_org = lay.origin(g, w0 + s / kSteps);
      cp.in(smem_addr(rows), q + lay.in(g, load_org, h, q0));
      cp.out(smem_addr(rows + T::kTileBytes),
             gout + lay.out(g, load_org, h, q0));
    }
    const uint32_t st = smem_addr(stages + (s % kStages) * T::kStageA);
    cp.in(st, k + lay.in(g, load_org, h, kb * kBlock));
    cp.in(st + T::kTileBytes, v + lay.in(g, load_org, h, kb * kBlock));
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  // the bias slice by thread, in units of the raw q . k sum (rel[h] /
  // scale; the base-2 logit is (q . k + bias) * sl): float4 f * 128 + tid
  // holds the thread's cells of n-tile f % 8 of key block f / 8, rows r0
  // and r1; d(rel) likewise, from 0. Each thread reads back only what it
  // wrote.
  {
    const float* rh = rel + ((int64_t)h * kN + q0) * kN;
    const float inv = 1.f / g.scale;
#pragma unroll 4
    for (int f = 0; f < kFrags; ++f) {
      const int c = (f >> 3) * kBlock + (f & 7) * 8 + cb;
      const float2 a = *reinterpret_cast<const float2*>(rh + r0 * kN + c);
      const float2 b = *reinterpret_cast<const float2*>(rh + r1 * kN + c);
      bias[f * kThreads + tid] =
          make_float4(a.x * inv, a.y * inv, b.x * inv, b.y * inv);
      drel[f * kThreads + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const float sl = g.scale * kLog2e;
  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  float o[HD / 8][4];
  // running max (units of 1 / sl), sum and sum of p dP of rows r0, r1;
  // then their lse (base 2) and rs
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, x0 = 0.f,
        x1 = 0.f, e0 = 0.f, e1 = 0.f, rs0 = 0.f, rs1 = 0.f;
  int uniform = 1, la = 0, lb = 0;
  for (int s = 0; s < nsteps; ++s) {
    const int i = s / kSteps, kb = s % kBlocks;
    const bool grads = (s / kBlocks) & 1;
    signed char* lw = labs + (i & 1) * kN;
    int same = 1;
    // window i's labels (window i - 1's, in the other half, may still be
    // read by a warp that is one step behind)
    if (s % kSteps == 0) same = window_labels(g, w0 + i, lw, tid);
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's)
    // ... everyone's, and every warp is past step s - 1, whose stage the
    // next load reuses
    const int all = __syncthreads_and(same);
    if (s + kStages - 1 < nsteps) load(s + kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact

    const uint32_t ks = smem_addr(stages + (s % kStages) * T::kStageA);
    const uint32_t vs = ks + T::kTileBytes;
    if (s % kSteps == 0) {
      wa_load_q<HD>(qa, smem_addr(rows), T::kPitch, warp, lane);
      wa_load_q<HD>(ga, smem_addr(rows) + T::kTileBytes, T::kPitch, warp,
                    lane);
      m0 = m1 = -INFINITY;
      l0 = l1 = x0 = x1 = 0.f;
      uniform = all;
      if (!uniform) {
        la = lw[q0 + r0];
        lb = lw[q0 + r1];
      }
    }

    // S = bias + Q K^T, -inf where the labels differ; dP = G V^T
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = bias[(kb * 8 + j) * kThreads + tid];
      sc[j][0] = b.x;
      sc[j][1] = b.y;
      sc[j][2] = b.z;
      sc[j][3] = b.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    }
    if (!uniform) {
      const signed char* lk = lw + kb * kBlock + cb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = lk[8 * j], c1 = lk[8 * j + 1];
        if (c0 != la) sc[j][0] = -INFINITY;
        if (c1 != la) sc[j][1] = -INFINITY;
        if (c0 != lb) sc[j][2] = -INFINITY;
        if (c1 != lb) sc[j][3] = -INFINITY;
      }
    }
    wa_qk_block<HD>(sc, qa, ks, T::kPitch, lane);
    wa_qk_block<HD>(dp, ga, vs, T::kPitch, lane);

    if (!grads) {
      // loop 1: the online softmax's max and sum, and r = sum p dP under
      // the same rescale; a row whose keys so far are all excluded keeps
      // max -inf and p = 0
      float y0 = m0, y1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y0 = fmaxf(y0, fmaxf(sc[j][0], sc[j][1]));
        y1 = fmaxf(y1, fmaxf(sc[j][2], sc[j][3]));
      }
      y0 = quad_max(y0);
      y1 = quad_max(y1);
      const float u0 = y0 == -INFINITY ? 0.f : y0 * sl;
      const float u1 = y1 == -INFINITY ? 0.f : y1 * sl;
      const float a0 = exp2_approx(fmaf(m0, sl, -u0));
      const float a1 = exp2_approx(fmaf(m1, sl, -u1));
      m0 = y0;
      m1 = y1;
      l0 *= a0;
      l1 *= a1;
      x0 *= a0;
      x1 *= a1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2_approx(fmaf(sc[j][0], sl, -u0));
        const float p1 = exp2_approx(fmaf(sc[j][1], sl, -u0));
        const float p2 = exp2_approx(fmaf(sc[j][2], sl, -u1));
        const float p3 = exp2_approx(fmaf(sc[j][3], sl, -u1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        x0 = fmaf(p0, dp[j][0], fmaf(p1, dp[j][1], x0));
        x1 = fmaf(p2, dp[j][2], fmaf(p3, dp[j][3], x1));
      }
      if (kb == kBlocks - 1) {
        // every row holds its own token, whose label agrees: l >= 1
        const float z0 = quad_sum(l0), z1 = quad_sum(l1);
        rs0 = quad_sum(x0) / z0;
        rs1 = quad_sum(x1) / z1;
        e0 = fmaf(m0, sl, log2f(z0));
        e1 = fmaf(m1, sl, log2f(z1));
        if ((lane & 3) == 0) {
          const int64_t row = ((int64_t)(w0 + i) * g.nH + h) * kN + q0;
          lse[row + r0] = e0;
          lse[row + r1] = e1;
          rsum[row + r0] = rs0;
          rsum[row + r1] = rs1;
        }
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
      }
      continue;
    }

    // loop 2: P = exp2(s - lse), dS = P (dP - rs): into d(rel) in fp32;
    // in bf16 as A fragments (n-tiles 2 kk, 2 kk + 1 make k-step kk)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        const float d0 =
            exp2_approx(fmaf(sc[j][0], sl, -e0)) * (dp[j][0] - rs0);
        const float d1 =
            exp2_approx(fmaf(sc[j][1], sl, -e0)) * (dp[j][1] - rs0);
        const float d2 =
            exp2_approx(fmaf(sc[j][2], sl, -e1)) * (dp[j][2] - rs1);
        const float d3 =
            exp2_approx(fmaf(sc[j][3], sl, -e1)) * (dp[j][3] - rs1);
        float4& c = drel[(kb * 8 + j) * kThreads + tid];
        float4 a = c;
        a.x += d0;
        a.y += d1;
        a.z += d2;
        a.w += d3;
        c = a;
        da[kk][2 * jj] = pack_bf16(d0, d1);
        da[kk][2 * jj + 1] = pack_bf16(d2, d3);
      }
    // dQ += dS K: K [key][d] through .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dn = 0; dn < HD / 8; dn += 2) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, ks + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                   T::kPitch +
                              (dn * 8 + (mi >> 1) * 8) * 2);
        mma_bf16(o[dn], da[kk], kf[0], kf[1]);
        mma_bf16(o[dn + 1], da[kk], kf[2], kf[3]);
      }
    if (kb == kBlocks - 1)
      store_rows<HD>(o, g.scale, dq, g, lay, lay.origin(g, w0 + i), h,
                     q0 + warp * 16, otile, lane);
  }

  // the run's d(rel): rows q0 .. q0 + 63 of head h of group grp's partial
  float* part = partial + (((int64_t)grp * g.nH + h) * kN + q0) * kN;
#pragma unroll 4
  for (int f = 0; f < kFrags; ++f) {
    const int c = (f >> 3) * kBlock + (f & 7) * 8 + cb;
    const float4 d = drel[f * kThreads + tid];
    *reinterpret_cast<float2*>(part + r0 * kN + c) = make_float2(d.x, d.y);
    *reinterpret_cast<float2*>(part + r1 * kN + c) = make_float2(d.z, d.w);
  }
}

// Kernel B: dK and dV.
template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, HD <= 32 ? 2 : 1)
    wa_mma256_bwd_cols_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ gout,
                              const float* __restrict__ rel,
                              const float* __restrict__ lse,
                              const float* __restrict__ rsum,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, WaGeometry g,
                              Layout lay, int total_windows,
                              int windows_per_cta) {
  using T = Bwd256Tile<HD>;
  constexpr int kSteps = kBlocks;  // a window: its 4 query blocks
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bias = reinterpret_cast<float4*>(smem);
  unsigned char* rows = smem + kSliceBytes;  // the window's K, V rows
  unsigned char* stages = rows + 2 * T::kTileBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* otile = stages + kStages * T::kStageB + warp * T::kOutBytes;
  signed char* labs = reinterpret_cast<signed char*>(
      stages + kStages * T::kStageB + 4 * T::kOutBytes);
  const int kb = blockIdx.x % kBlocks;
  const int h = (blockIdx.x / kBlocks) % g.nH;
  const int grp = (blockIdx.x / kBlocks) / g.nH;
  const int w0 = grp * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows - w0);
  const int nsteps = nwin * kSteps;
  const int k0 = kb * kBlock;  // the CTA's first key token
  // the thread's S^T fragment: rows (keys) r0, r1 = r0 + 8 of the key
  // block; columns (queries) 8 j + cb, + 1 of the query block
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;

  const BlockCopy<HD> cp(g, lay, tid);
  // step s = (window s / 4, query block s % 4) into stage s % kStages: the
  // query block's Q and G rows and their lse and rs and, in a window's
  // first step, the key block's K and V rows
  int64_t load_org = 0;
  auto load = [&](int s) {
    const int qb = s % kBlocks, w = w0 + s / kSteps;
    if (qb == 0) {
      load_org = lay.origin(g, w);
      cp.in(smem_addr(rows), k + lay.in(g, load_org, h, k0));
      cp.in(smem_addr(rows + T::kTileBytes), v + lay.in(g, load_org, h, k0));
    }
    const uint32_t st = smem_addr(stages + (s % kStages) * T::kStageB);
    cp.in(st, q + lay.in(g, load_org, h, qb * kBlock));
    cp.out(st + T::kTileBytes, gout + lay.out(g, load_org, h, qb * kBlock));
    if (tid < 32)
      cp_async16(st + 2 * T::kTileBytes + tid * 16,
                 (tid < 16 ? lse : rsum) +
                     ((int64_t)w * g.nH + h) * kN + qb * kBlock +
                     (tid & 15) * 4);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  // rel[h]^T's slice by thread, in units of the raw k . q sum: float4
  // f * 128 + tid holds the thread's cells of n-tile f % 8 of query block
  // f / 8, key rows r0 and r1
  {
    const float* rh = rel + (int64_t)h * kN * kN + k0;
    const float inv = 1.f / g.scale;
#pragma unroll 4
    for (int f = 0; f < kFrags; ++f) {
      const int c = (f >> 3) * kBlock + (f & 7) * 8 + cb;
      const float* a = rh + c * kN;
      bias[f * kThreads + tid] =
          make_float4(a[r0] * inv, a[kN + r0] * inv, a[r1] * inv,
                      a[kN + r1] * inv);
    }
  }

  const float sl = g.scale * kLog2e;
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float ak[HD / 8][4], av[HD / 8][4];
  int uniform = 1, la = 0, lb = 0;
  for (int s = 0; s < nsteps; ++s) {
    const int i = s / kSteps, qb = s % kBlocks;
    signed char* lw = labs + (i & 1) * kN;
    int same = 1;
    if (qb == 0) same = window_labels(g, w0 + i, lw, tid);
    cp_async_wait<kStages - 2>();
    const int all = __syncthreads_and(same);
    if (s + kStages - 1 < nsteps) load(s + kStages - 1);
    cp_async_commit();

    const unsigned char* stage = stages + (s % kStages) * T::kStageB;
    const uint32_t qs = smem_addr(stage), gs = qs + T::kTileBytes;
    const float* ls = reinterpret_cast<const float*>(stage +
                                                     2 * T::kTileBytes);
    const float* rss = ls + kBlock;
    if (qb == 0) {
      wa_load_q<HD>(ka, smem_addr(rows), T::kPitch, warp, lane);
      wa_load_q<HD>(va, smem_addr(rows) + T::kTileBytes, T::kPitch, warp,
                    lane);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[dn][e] = av[dn][e] = 0.f;
      uniform = all;
      if (!uniform) {
        la = lw[k0 + r0];
        lb = lw[k0 + r1];
      }
    }

    // S^T = bias^T + K Q^T, -inf where the labels differ; dP^T = V G^T
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = bias[(qb * 8 + j) * kThreads + tid];
      st[j][0] = b.x;
      st[j][1] = b.y;
      st[j][2] = b.z;
      st[j][3] = b.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
    }
    if (!uniform) {
      const signed char* lq = lw + qb * kBlock + cb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = lq[8 * j], c1 = lq[8 * j + 1];
        if (c0 != la) st[j][0] = -INFINITY;
        if (c1 != la) st[j][1] = -INFINITY;
        if (c0 != lb) st[j][2] = -INFINITY;
        if (c1 != lb) st[j][3] = -INFINITY;
      }
    }
    wa_qk_block<HD>(st, ka, qs, T::kPitch, lane);
    wa_qk_block<HD>(dpt, va, gs, T::kPitch, lane);

    // P^T = exp2(s^T - lse of the query), dS^T = P^T (dP^T - rs of the
    // query), in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 e = *reinterpret_cast<const float2*>(ls + 8 * j + cb);
      const float2 r = *reinterpret_cast<const float2*>(rss + 8 * j + cb);
      st[j][0] = exp2_approx(fmaf(st[j][0], sl, -e.x));
      st[j][1] = exp2_approx(fmaf(st[j][1], sl, -e.y));
      st[j][2] = exp2_approx(fmaf(st[j][2], sl, -e.x));
      st[j][3] = exp2_approx(fmaf(st[j][3], sl, -e.y));
      dpt[j][0] = st[j][0] * (dpt[j][0] - r.x);
      dpt[j][1] = st[j][1] * (dpt[j][1] - r.y);
      dpt[j][2] = st[j][2] * (dpt[j][2] - r.x);
      dpt[j][3] = st[j][3] * (dpt[j][3] - r.y);
    }
    // dV += P^T G, dK += dS^T Q: bf16 A fragments from the accumulators,
    // G and Q [query][d] through ldmatrix.trans
    wa_pv_block<HD>(av, st, 1.f, 1.f, gs, T::kPitch, lane);
    wa_pv_block<HD>(ak, dpt, 1.f, 1.f, qs, T::kPitch, lane);

    if (qb == kBlocks - 1) {
      const int64_t org = lay.origin(g, w0 + i);
      store_rows<HD>(av, 1.f, dv, g, lay, org, h, k0 + warp * 16, otile,
                     lane);
      store_rows<HD>(ak, g.scale, dk, g, lay, org, h, k0 + warp * 16, otile,
                     lane);
    }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* gout,
              const float* rel, void* dq, void* dk, void* dv, float* lse,
              float* rsum, float* partial, float* drel, const WaGeometry& g,
              const NhwcWindowLayout<kWs>& lay, int total_windows,
              int wpc_rows, int wpc_cols, cudaStream_t stream) {
  using Lay = NhwcWindowLayout<kWs>;
  using B16 = __nv_bfloat16;
  auto ka = wa_mma256_bwd_rows_kernel<HD, Lay>;
  auto kb = wa_mma256_bwd_cols_kernel<HD, Lay>;
  cudaError_t e = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd256Tile<HD>::kSmemA);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Bwd256Tile<HD>::kSmemB);
  if (e != cudaSuccess) return (int)e;
  const int groups = (total_windows + wpc_rows - 1) / wpc_rows;
  ka<<<groups * g.nH * kBlocks, kThreads, Bwd256Tile<HD>::kSmemA, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<const B16*>(gout), rel,
      static_cast<B16*>(dq), lse, rsum, partial, g, lay, total_windows,
      wpc_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int runs = (total_windows + wpc_cols - 1) / wpc_cols;
  kb<<<runs * g.nH * kBlocks, kThreads, Bwd256Tile<HD>::kSmemB, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<const B16*>(gout), rel, lse,
      rsum, static_cast<B16*>(dk), static_cast<B16*>(dv), g, lay,
      total_windows, wpc_cols);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return wa_drel_sum(partial, drel, groups, g.nH * kN * kN, stream);
}

}  // namespace

extern "C" {

// K6 in bf16 at windows of 16 x 16: fused (q = the (B, Hp, Wp, 3C) qkv map
// and dq = the dqkv map; k, v, dk, dv ignored) or split q, k, v and dq, dk,
// dv maps (B, Hp, Wp, C); gout (B, Hp, Wp, C) bf16; rel (nH, 256, 256)
// fp32. lse and rsum hold B * nW x nH x 256 floats (kernel A's row
// statistics for kernel B), partial ceil(B * nW / wpc_rows) x nH x 256 x
// 256 floats, drel nH x 256 x 256; wpc_rows and wpc_cols are the two
// kernels' windows per CTA (the wrapper's `mma256_bwd_plan`). pad_h =
// pad_w = 0: no pad labels. The operands, gout, the gradients, lse and
// rsum must be 16-byte aligned, rel and partial 8-byte. Returns
// cudaGetLastError() (0 = launched).
int window_attn_nhwc_mma256_bwd(const void* q, const void* k, const void* v,
                                const void* gout, const void* rel, void* dq,
                                void* dk, void* dv, void* lse, void* rsum,
                                void* partial, void* drel, int fused, int B,
                                int nH, int C, int Hp, int Wp, int shift,
                                int pad_h, int pad_w, int wpc_rows,
                                int wpc_cols, float scale, void* stream) {
  if (B < 1 || nH < 1 || C % nH || wpc_rows < 1 || wpc_cols < 1 ||
      shift < 0 || shift >= kWs || Hp < kWs || Wp < kWs)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / kWs) * (Wp / kWs);
  const WaGeometry g = {nW, nH, kN, C / nH, C, Hp, Wp, kWs, shift,
                        pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  const char* qb = static_cast<const char*>(q);
  char* db = static_cast<char*>(dq);
  const void* kp = fused ? qb + (size_t)C * 2 : k;
  const void* vp = fused ? qb + (size_t)C * 4 : v;
  void* dkp = fused ? db + (size_t)C * 2 : dk;
  void* dvp = fused ? db + (size_t)C * 4 : dv;
  if (((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)gout |
       (uintptr_t)dq | (uintptr_t)dkp | (uintptr_t)dvp | (uintptr_t)lse |
       (uintptr_t)rsum) & 15 ||
      ((uintptr_t)rel | (uintptr_t)partial) & 7)
    return (int)cudaErrorMisalignedAddress;
  const NhwcWindowLayout<kWs> lay = {fused ? 3 * (int64_t)C : (int64_t)C,
                                     (int64_t)C};
  const int total = B * nW;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* ls = static_cast<float*>(lse);
  float* rsm = static_cast<float*>(rsum);
  float* pp = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  switch (g.hd) {
    case 16:
      return launch_hd<16>(q, kp, vp, gout, r, dq, dkp, dvp, ls, rsm, pp, dr,
                           g, lay, total, wpc_rows, wpc_cols, st);
    case 32:
      return launch_hd<32>(q, kp, vp, gout, r, dq, dkp, dvp, ls, rsm, pp, dr,
                           g, lay, total, wpc_rows, wpc_cols, st);
    case 48:
      return launch_hd<48>(q, kp, vp, gout, r, dq, dkp, dvp, ls, rsm, pp, dr,
                           g, lay, total, wpc_rows, wpc_cols, st);
    case 64:
      return launch_hd<64>(q, kp, vp, gout, r, dq, dkp, dvp, ls, rsm, pp, dr,
                           g, lay, total, wpc_rows, wpc_cols, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* window_attn_mma256_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
