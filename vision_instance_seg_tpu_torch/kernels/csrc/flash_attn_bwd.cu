// K9a and K9b: the full-attention encoder's self-attention backward
// (Hopper, sm_90a), the gradients of out = softmax(q . k^T * scale) . v
// over (B, nH, S, hd), no mask. They replace the two kernels of the
// flash-attention backward that JAX runs under the custom_vjp of
// jax/experimental/pallas/ops/tpu/flash_attention.py:204 when
// vision_instance_seg_tpu/models/pixel_decoder.py:120
// `_flash_or_dense_attention` is differentiated on a TPU:
// `_flash_attention_bwd_dkv` (:941, pallas_call :1121) and
// `_flash_attention_bwd_dq` (:1287, pallas_call :1456), which
// `_flash_attention_bwd` (:254-311) runs one after the other. The split is
// the TPU's (and FlashAttention-2's): from q, k, v, the cotangent g = dO,
// each row's log-sum-exp from the forward (K8 writes it, flash_attn_fwd.cu)
// and D = rowsum(o * dO) (a torch expression before both, as JAX's :273),
//   P = exp(q . k^T scale - lse),  dP = dO . v^T,  dS = P (dP - D),
//   dV = P^T dO,  dK = dS^T q scale,  dQ = dS k scale;
// K9a (`flash_bwd_dkv_*`) owns a block of 64 keys and loops over the query
// blocks (dK and dV sum in registers); K9b (`flash_bwd_dq_*`) owns a block
// of 64 queries and loops over the key blocks (dQ sums in registers). Both
// recompute P and dP. Nothing is atomic.
//
// Bound, at the training shape (B 2, nH 8, S = 80^2 + 40^2 + 20^2 = 8,400,
// hd 32, bf16): B nH S^2 = 1.13e9 logits. Each kernel recomputes P, one ex2
// a logit: 2.26e9 ex2 at 16 a clock per SM (132 SMs, ~1.98 GHz, ~4.2e12 a
// second) ~0.54 ms for the pair. The products: K9a S^T, dP^T, dV, dK; K9b
// S, dP, dQ; seven of 2 S^2 hd a head, 0.51 ms at 989 TFLOP/s. q, k, v, dO
// in and dQ, dK, dV out are 7 x 8.6 MB, ~0.02 ms at 3.35 TB/s. So the
// exponent unit bounds the pair, the tensor cores nearly as much; a fused
// one-kernel design (one ex2 a logit, five products, fp32 atomics for dQ)
// would be bound at ~0.37 ms and is later work.
//
// Design, bf16 (the training path's type), mma.sync m16n8k16 with the
// building blocks of window_attn_mma.cuh, one CTA of 4 warps, each warp 16
// rows of the CTA's block:
// - K9a: grid (ceil(S / 64), B nH), one CTA per (64-key block, batch x
//   head). The CTA's K and V rows stay in shared memory for the whole loop;
//   a ring of stages (3 at hd <= 64, 2 above) brings each query block's Q
//   and dO rows (16-byte cp.async) and its lse and D (512 bytes). A step:
//   S^T = K Q^T and dP^T = V dO^T (K and V rows as A fragments, loaded
//   from shared memory one k-step at a time so that the dK and dV
//   accumulators have the registers at hd 128; Q and dO through ldmatrix),
//   P^T = exp2((s scale - lse) log2 e), dS^T = P^T (dP^T - D), then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as A
//   fragments from the accumulators and dO, Q through ldmatrix.trans.
// - K9b: the same grid, one CTA per (64-query block, batch x head). Q and
//   dO rows stay in shared memory, each row's lse and D in registers; the
//   ring brings each key block's K and V rows. A step: S = Q K^T and
//   dP = dO V^T, P and dS as above, dQ += dS K (dS rounded to bf16 as the
//   A fragment, K through ldmatrix.trans).
// - the ragged tail: 8,400 = 131 x 64 + 16 (13,125 = 205 x 64 + 5 at
//   800 px). Rows past S of every staged block are zero-filled by the
//   copies from a clamped address (the block's first row, a real one). K9a
//   sets P to 0 in the columns of queries past S (their lse and D are
//   whatever the padding holds), so those add nothing to dK or dV; K9b
//   sets the logits of keys past S to -inf, so their P and dS are 0 and
//   add nothing to dQ. Rows past S of the CTA's own block are computed and
//   not stored. The row statistics are (B nH) rows of `stat_row` floats, a
//   multiple of 64, so that a query block's 64 of them copy as 16-byte
//   pieces.
// - operands and gradients are addressed by (batch, head, token) strides:
//   the encoder passes its (B, S, nH, hd) projections and cotangent as
//   (B, nH, S, hd) views and gets dQ, dK, dV back in that layout, without
//   a transpose. Rows must start 16-byte aligned. Each warp writes its 16
//   rows of a gradient through its own 16 rows of the CTA's resident block
//   in shared memory (stmatrix, then 16-byte stores).
// No wgmma, TMA or warp specialisation yet.
//
// fp32: SIMT bodies of the same loops, right rather than fast, as K8's:
// 4 lanes a row of the CTA's block (each holding hd / 4 of its operands
// and accumulators, as float4s interleaved so that a quad reads 64
// contiguous bytes of a staged row), 64 rows a CTA, the other operand's
// block of 64 rows in shared memory, one row of it at a time.
//
// Numerics against the plain version (kernels/flash_attention.py
// `flash_attention_bwd_torch`, JAX's `mha_reference_bwd` rounding for
// rounding: fp32 P, dP, dS and sums, each gradient cast once): bf16 rounds
// P and dS to bf16 before the products dV, dK and dQ, as K6 and
// FlashAttention-2 do; the bound 2^-7 |plain| + 2^-8 max|plain| per
// gradient is pinned on the CPU by a block-wise emulation of that rounding
// (tests/test_torch_port_full_encoder_train.py). fp32 sums in another order
// with ex2.approx.

#include <stdint.h>

#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps x 16 rows
constexpr int kBlock = 64;         // rows per CTA; rows per step
constexpr int kSimtThreads = 256;  // fp32: 4 lanes x 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// element strides of (batch, head, token) for q, k, v, the cotangent g and
// the gradients dq, dk, dv; the head dim is contiguous. lse and D: (B nH)
// rows of stat_row floats.
struct BwdGeom {
  int B, nH, S, hd;
  int64_t q[3], k[3], v[3], g[3], dq[3], dk[3], dv[3];
  int64_t stat_row;
  float scale;
};

template <int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;              // 16-byte pieces a row
  static constexpr int kPitch = HD * 2 + 16;          // staged row, bytes
  static constexpr int kTileBytes = kBlock * kPitch;  // 64 rows
  static constexpr int kStatBytes = 2 * kBlock * 4;   // lse, D of 64 rows
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  // the CTA's two resident tiles, then the ring: two tiles a step, and in
  // K9a the step's statistics
  static constexpr int kStageDkv = 2 * kTileBytes + kStatBytes;
  static constexpr int kStageDq = 2 * kTileBytes;
  static constexpr int kSmemDkv = 2 * kTileBytes + kStages * kStageDkv;
  static constexpr int kSmemDq = 2 * kTileBytes + kStages * kStageDq;
};

// The thread's 16-byte pieces of a 64-row tile: c = tid + 128 it, at row
// c / (HD / 8), piece c % (HD / 8).
template <int HD>
struct TileCopy {
  int trow[HD / 16], soff[HD / 16], gcol[HD / 16];

  __device__ __forceinline__ explicit TileCopy(int tid) {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int c = tid + it * kThreads;
      trow[it] = c / Tile<HD>::kChunks;
      soff[it] = trow[it] * Tile<HD>::kPitch + (c % Tile<HD>::kChunks) * 16;
      gcol[it] = (c % Tile<HD>::kChunks) * 8;
    }
  }
  // rows t0 .. t0 + 63 of a head (token stride st) into the tile at dst;
  // rows >= S are zeros, copied from nowhere (the source clamped to row
  // t0, a real one)
  __device__ __forceinline__ void operator()(uint32_t dst,
                                             const __nv_bfloat16* base,
                                             int64_t st, int t0,
                                             int S) const {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int t = t0 + trow[it];
      const bool real = t < S;
      cp_async16_zfill(dst + soff[it], base + (real ? t : t0) * st + gcol[it],
                       real ? 16 : 0);
    }
  }
};

// s += A B^T for the warp's 16 rows of A (staged at as) against the 64
// rows of B (staged at bs): 8 n-tiles of 8 rows x HD / 16 k-steps, A's
// fragment loaded per k-step (4 registers, not HD / 4), B through ldmatrix
template <int HD>
__device__ __forceinline__ void rows_x_block(float (&s)[8][4], uint32_t as,
                                             uint32_t bs, int pitch,
                                             int warp, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * pitch +
                   (kk * 16 + (mi >> 1) * 8) * 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, bs + (8 * j + (lane & 7)) * pitch +
                          (kk * 16 + (mi & 1) * 8) * 2);
      mma_bf16(s[j], a, b0, b1);
    }
  }
}

// The warp's 16 rows of a gradient (a 16 x HD accumulator, times sc) to
// tokens t0 .. t0 + 15 of a head (token stride st), the real ones only,
// through `tile` (the warp's own 16 staged rows, which no other warp
// reads): stmatrix, then 16-byte stores.
template <int HD>
__device__ __forceinline__ void store_warp_rows(const float (&o)[HD / 8][4],
                                                float sc,
                                                __nv_bfloat16* base,
                                                int64_t st, int t0, int S,
                                                unsigned char* tile,
                                                int lane) {
  constexpr int kPitch = Tile<HD>::kPitch, kChunks = HD / 8;
  const int mi = lane >> 3;
  const uint32_t ta = smem_addr(tile);
  __syncwarp();  // every lane is done reading the tile's rows
#pragma unroll
  for (int dn = 0; dn < HD / 8; dn += 2) {
    const uint32_t r[4] = {pack_bf16(o[dn][0] * sc, o[dn][1] * sc),
                           pack_bf16(o[dn][2] * sc, o[dn][3] * sc),
                           pack_bf16(o[dn + 1][0] * sc, o[dn + 1][1] * sc),
                           pack_bf16(o[dn + 1][2] * sc, o[dn + 1][3] * sc)};
    stsm_x4(ta + ((mi & 1) * 8 + (lane & 7)) * kPitch +
                (dn * 8 + (mi >> 1) * 8) * 2,
            r);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < HD / 16; ++it) {
    const int c = lane + it * 32;
    const int row = c / kChunks, ch = c % kChunks;
    if (t0 + row < S)
      *reinterpret_cast<uint4*>(base + (t0 + row) * st + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + row * kPitch + ch * 16);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// K9a, bf16: dK and dV of one 64-key block.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, BwdGeom geo) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBlock;  // the CTA's first key token
  const int b = blockIdx.y / geo.nH, h = blockIdx.y - b * geo.nH;
  const int nqb = (geo.S + kBlock - 1) / kBlock;
  const __nv_bfloat16* qh = q + b * geo.q[0] + h * geo.q[1];
  const __nv_bfloat16* gh = g + b * geo.g[0] + h * geo.g[1];
  const float* lh = lse + blockIdx.y * geo.stat_row;
  const float* dh = delta + blockIdx.y * geo.stat_row;

  const TileCopy<HD> copy(tid);
  unsigned char* ktile = smem;  // the CTA's K rows, then its V rows
  unsigned char* vtile = smem + T::kTileBytes;
  const uint32_t ks = smem_addr(ktile), vs = smem_addr(vtile);
  auto stage = [&](int j) {
    return smem + 2 * T::kTileBytes + (j % T::kStages) * T::kStageDkv;
  };
  // query block j's Q and dO rows and its 64 lse and D into its stage
  auto load = [&](int j) {
    const uint32_t st = smem_addr(stage(j));
    copy(st, qh, geo.q[2], j * kBlock, geo.S);
    copy(st + T::kTileBytes, gh, geo.g[2], j * kBlock, geo.S);
    if (tid < 32)
      cp_async16(st + 2 * T::kTileBytes + tid * 16,
                 (tid < 16 ? lh : dh) + j * kBlock + (tid & 15) * 4);
  };
  // in the first group, with query block 0
  copy(ks, k + b * geo.k[0] + h * geo.k[1], geo.k[2], k0, geo.S);
  copy(vs, v + b * geo.v[0] + h * geo.v[1], geo.v[2], k0, geo.S);
#pragma unroll
  for (int j = 0; j < T::kStages - 1; ++j) {
    if (j < nqb) load(j);
    cp_async_commit();
  }

  // the thread's S^T fragment: key rows r0, r0 + 8 of the CTA's block;
  // query columns 8 jj + cb, + 1 of the step's block
  const int cb = (lane & 3) * 2;
  float adk[HD / 8][4], adv[HD / 8][4];
  zero(adk);
  zero(adv);
  for (int j = 0; j < nqb; ++j) {
    cp_async_wait<T::kStages - 2>();  // query block j has landed (this
    __syncthreads();  // thread's; now everyone's), and every warp is past
                      // step j - 1, whose stage the next load reuses
    if (j + T::kStages - 1 < nqb) load(j + T::kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact
    const unsigned char* sp = stage(j);
    const uint32_t qs = smem_addr(sp), gs = qs + T::kTileBytes;
    const float* ls = reinterpret_cast<const float*>(sp + 2 * T::kTileBytes);
    const float* ds = ls + kBlock;

    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    rows_x_block<HD>(st, ks, qs, T::kPitch, warp, lane);   // S^T = K Q^T
    rows_x_block<HD>(dpt, vs, gs, T::kPitch, warp, lane);  // dP^T = V dO^T
    const int real = geo.S - j * kBlock;  // real queries in this block
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + cb;
      const float2 e = *reinterpret_cast<const float2*>(ls + c);
      const float2 d = *reinterpret_cast<const float2*>(ds + c);
      float p0 = exp2_approx(fmaf(st[jj][0], geo.scale, -e.x) * kLog2e);
      float p1 = exp2_approx(fmaf(st[jj][1], geo.scale, -e.y) * kLog2e);
      float p2 = exp2_approx(fmaf(st[jj][2], geo.scale, -e.x) * kLog2e);
      float p3 = exp2_approx(fmaf(st[jj][3], geo.scale, -e.y) * kLog2e);
      if (c >= real) p0 = p2 = 0.f;
      if (c + 1 >= real) p1 = p3 = 0.f;
      st[jj][0] = p0;
      st[jj][1] = p1;
      st[jj][2] = p2;
      st[jj][3] = p3;
      dpt[jj][0] = p0 * (dpt[jj][0] - d.x);
      dpt[jj][1] = p1 * (dpt[jj][1] - d.y);
      dpt[jj][2] = p2 * (dpt[jj][2] - d.x);
      dpt[jj][3] = p3 * (dpt[jj][3] - d.y);
    }
    // dV += P^T dO, dK += dS^T Q (bf16 A fragments from the accumulators)
    wa_pv_block<HD>(adv, st, 1.f, 1.f, gs, T::kPitch, lane);
    wa_pv_block<HD>(adk, dpt, 1.f, 1.f, qs, T::kPitch, lane);
  }

  const int t0 = k0 + warp * 16;
  store_warp_rows<HD>(adk, geo.scale, dk + b * geo.dk[0] + h * geo.dk[1],
                      geo.dk[2], t0, geo.S, ktile + warp * 16 * T::kPitch,
                      lane);
  store_warp_rows<HD>(adv, 1.f, dv + b * geo.dv[0] + h * geo.dv[1],
                      geo.dv[2], t0, geo.S, vtile + warp * 16 * T::kPitch,
                      lane);
}

// K9b, bf16: dQ of one 64-query block.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, BwdGeom geo) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock;  // the CTA's first query token
  const int b = blockIdx.y / geo.nH, h = blockIdx.y - b * geo.nH;
  const int nkb = (geo.S + kBlock - 1) / kBlock;
  const __nv_bfloat16* kh = k + b * geo.k[0] + h * geo.k[1];
  const __nv_bfloat16* vh = v + b * geo.v[0] + h * geo.v[1];

  const TileCopy<HD> copy(tid);
  unsigned char* qtile = smem;  // the CTA's Q rows, then its dO rows
  const uint32_t qs = smem_addr(qtile), gs = qs + T::kTileBytes;
  auto stage = [&](int j) {
    return smem_addr(smem) + 2 * T::kTileBytes + (j % T::kStages) *
                                                     T::kStageDq;
  };
  auto load = [&](int j) {
    const uint32_t st = stage(j);
    copy(st, kh, geo.k[2], j * kBlock, geo.S);
    copy(st + T::kTileBytes, vh, geo.v[2], j * kBlock, geo.S);
  };
  copy(qs, q + b * geo.q[0] + h * geo.q[1], geo.q[2], q0, geo.S);
  copy(gs, g + b * geo.g[0] + h * geo.g[1], geo.g[2], q0, geo.S);
#pragma unroll
  for (int j = 0; j < T::kStages - 1; ++j) {
    if (j < nkb) load(j);
    cp_async_commit();
  }

  // the thread's S fragment: query rows r0, r0 + 8 of the CTA's block;
  // key columns 8 jj + cb, + 1 of the step's block. Their lse and D (0 for
  // rows past S, which are not stored).
  const int r0 = warp * 16 + (lane >> 2), cb = (lane & 3) * 2;
  const int mi = lane >> 3;
  const int t0 = q0 + r0, t1 = t0 + 8;
  const float* lh = lse + blockIdx.y * geo.stat_row;
  const float* dh = delta + blockIdx.y * geo.stat_row;
  const float e0 = t0 < geo.S ? lh[t0] : 0.f, e1 = t1 < geo.S ? lh[t1] : 0.f;
  const float d0 = t0 < geo.S ? dh[t0] : 0.f, d1 = t1 < geo.S ? dh[t1] : 0.f;
  float adq[HD / 8][4];
  zero(adq);
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    if (j + T::kStages - 1 < nkb) load(j + T::kStages - 1);
    cp_async_commit();
    const uint32_t ks = stage(j), vs = ks + T::kTileBytes;

    float sc[8][4], dp[8][4];
    zero(sc);
    zero(dp);
    rows_x_block<HD>(sc, qs, ks, T::kPitch, warp, lane);  // S = Q K^T
    rows_x_block<HD>(dp, gs, vs, T::kPitch, warp, lane);  // dP = dO V^T
    const int real = geo.S - j * kBlock;  // real keys in this block
    if (real < kBlock) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (8 * jj + cb >= real) sc[jj][0] = sc[jj][2] = -INFINITY;
        if (8 * jj + cb + 1 >= real) sc[jj][1] = sc[jj][3] = -INFINITY;
      }
    }
    // dS = P (dP - D) in bf16 as A fragments (n-tiles 2 kk, 2 kk + 1 make
    // k-step kk)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jj = 2 * kk + half;
        const float p0 = exp2_approx(fmaf(sc[jj][0], geo.scale, -e0) * kLog2e);
        const float p1 = exp2_approx(fmaf(sc[jj][1], geo.scale, -e0) * kLog2e);
        const float p2 = exp2_approx(fmaf(sc[jj][2], geo.scale, -e1) * kLog2e);
        const float p3 = exp2_approx(fmaf(sc[jj][3], geo.scale, -e1) * kLog2e);
        da[kk][2 * half] =
            pack_bf16(p0 * (dp[jj][0] - d0), p1 * (dp[jj][1] - d0));
        da[kk][2 * half + 1] =
            pack_bf16(p2 * (dp[jj][2] - d1), p3 * (dp[jj][3] - d1));
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
        mma_bf16(adq[dn], da[kk], kf[0], kf[1]);
        mma_bf16(adq[dn + 1], da[kk], kf[2], kf[3]);
      }
  }

  store_warp_rows<HD>(adq, geo.scale, dq + b * geo.dq[0] + h * geo.dq[1],
                      geo.dq[2], q0 + warp * 16, geo.S,
                      qtile + warp * 16 * T::kPitch, lane);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// y + x * a, elementwise
__device__ __forceinline__ float4 fma4(float4 x, float a, float4 y) {
  return make_float4(fmaf(x.x, a, y.x), fmaf(x.y, a, y.y), fmaf(x.z, a, y.z),
                     fmaf(x.w, a, y.w));
}

__device__ __forceinline__ float quad_dot(float acc) {
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// 64 rows t0 .. of two operands of one head into two fp32 tiles (rows
// past S zero) by the CTA's 256 threads
template <int HD>
__device__ __forceinline__ void simt_stage(float4* ta, float4* tb,
                                           const float* a, int64_t sa,
                                           const float* b, int64_t sb,
                                           int t0, int n) {
  constexpr int kRow4 = HD / 4;
  for (int c = threadIdx.x; c < kBlock * kRow4; c += kSimtThreads) {
    const int r = c / kRow4, cc = c - r * kRow4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < n) {
      x = reinterpret_cast<const float4*>(a + (t0 + r) * sa)[cc];
      y = reinterpret_cast<const float4*>(b + (t0 + r) * sb)[cc];
    }
    ta[c] = x;
    tb[c] = y;
  }
}

// K9a, fp32 SIMT: lane `part` of key row `row` holds float4 number
// part + 4 i (i < HD / 16) of k, v, dK and dV
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dkv_simt_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              BwdGeom geo) {
  constexpr int kVec = HD / 16, kRow4 = HD / 4;
  extern __shared__ float4 tiles[];
  float4* qt = tiles;                  // 64 query rows x HD
  float4* gt = tiles + kBlock * kRow4;  // their cotangent rows
  float* lt = reinterpret_cast<float*>(gt + kBlock * kRow4);  // lse, D
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int b = blockIdx.y / geo.nH, h = blockIdx.y - b * geo.nH;
  const int t = blockIdx.x * kBlock + row;
  const bool real_row = t < geo.S;
  const float* qh = q + b * geo.q[0] + h * geo.q[1];
  const float* gh = g + b * geo.g[0] + h * geo.g[1];
  const float* lh = lse + blockIdx.y * geo.stat_row;
  const float* dh = delta + blockIdx.y * geo.stat_row;
  const int tr = real_row ? t : 0;
  const float4* kr = reinterpret_cast<const float4*>(
      k + b * geo.k[0] + h * geo.k[1] + tr * geo.k[2]);
  const float4* vr = reinterpret_cast<const float4*>(
      v + b * geo.v[0] + h * geo.v[1] + tr * geo.v[2]);
  float4 kv[kVec], vv[kVec], ak[kVec], av[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    kv[i] = kr[part + 4 * i];
    vv[i] = vr[part + 4 * i];
    ak[i] = av[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j0 = 0; j0 < geo.S; j0 += kBlock) {
    const int nq = min(kBlock, geo.S - j0);
    __syncthreads();  // every row is done with the previous tiles
    simt_stage<HD>(qt, gt, qh, geo.q[2], gh, geo.g[2], j0, nq);
    if (tid < 2 * kBlock) {
      const int r = tid & (kBlock - 1);
      lt[tid] = r < nq ? (tid < kBlock ? lh : dh)[j0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int u = 0; u < nq; ++u) {
      const float4* qu = qt + u * kRow4;
      const float4* gu = gt + u * kRow4;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s += dot4(kv[i], qu[part + 4 * i]);
        dp += dot4(vv[i], gu[part + 4 * i]);
      }
      s = quad_dot(s);
      dp = quad_dot(dp);
      const float p = exp2_approx(fmaf(s, geo.scale, -lt[u]) * kLog2e);
      const float ds = p * (dp - lt[kBlock + u]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        av[i] = fma4(gu[part + 4 * i], p, av[i]);
        ak[i] = fma4(qu[part + 4 * i], ds, ak[i]);
      }
    }
  }
  if (real_row) {
    float4* kout = reinterpret_cast<float4*>(dk + b * geo.dk[0] +
                                             h * geo.dk[1] + t * geo.dk[2]);
    float4* vout = reinterpret_cast<float4*>(dv + b * geo.dv[0] +
                                             h * geo.dv[1] + t * geo.dv[2]);
    const float sc = geo.scale;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      kout[part + 4 * i] =
          make_float4(ak[i].x * sc, ak[i].y * sc, ak[i].z * sc, ak[i].w * sc);
      vout[part + 4 * i] = av[i];
    }
  }
}

// K9b, fp32 SIMT: lane `part` of query row `row` holds float4 number
// part + 4 i of q, dO and dQ
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, BwdGeom geo) {
  constexpr int kVec = HD / 16, kRow4 = HD / 4;
  extern __shared__ float4 tiles[];
  float4* kt = tiles;                   // 64 key rows x HD
  float4* vt = tiles + kBlock * kRow4;  // their value rows
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int b = blockIdx.y / geo.nH, h = blockIdx.y - b * geo.nH;
  const int t = blockIdx.x * kBlock + row;
  const bool real_row = t < geo.S;
  const float* kh = k + b * geo.k[0] + h * geo.k[1];
  const float* vh = v + b * geo.v[0] + h * geo.v[1];
  const int tr = real_row ? t : 0;
  const float4* qr = reinterpret_cast<const float4*>(
      q + b * geo.q[0] + h * geo.q[1] + tr * geo.q[2]);
  const float4* gr = reinterpret_cast<const float4*>(
      g + b * geo.g[0] + h * geo.g[1] + tr * geo.g[2]);
  const float e = lse[blockIdx.y * geo.stat_row + tr];
  const float d = delta[blockIdx.y * geo.stat_row + tr];
  float4 qv[kVec], gv[kVec], aq[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = qr[part + 4 * i];
    gv[i] = gr[part + 4 * i];
    aq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j0 = 0; j0 < geo.S; j0 += kBlock) {
    const int nk = min(kBlock, geo.S - j0);
    __syncthreads();
    simt_stage<HD>(kt, vt, kh, geo.k[2], vh, geo.v[2], j0, nk);
    __syncthreads();
#pragma unroll 2
    for (int u = 0; u < nk; ++u) {
      const float4* ku = kt + u * kRow4;
      const float4* vu = vt + u * kRow4;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s += dot4(qv[i], ku[part + 4 * i]);
        dp += dot4(gv[i], vu[part + 4 * i]);
      }
      s = quad_dot(s);
      dp = quad_dot(dp);
      const float p = exp2_approx(fmaf(s, geo.scale, -e) * kLog2e);
      const float ds = p * (dp - d);
#pragma unroll
      for (int i = 0; i < kVec; ++i) aq[i] = fma4(ku[part + 4 * i], ds, aq[i]);
    }
  }
  if (real_row) {
    float4* out = reinterpret_cast<float4*>(dq + b * geo.dq[0] +
                                            h * geo.dq[1] + t * geo.dq[2]);
    const float sc = geo.scale;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out[part + 4 * i] =
          make_float4(aq[i].x * sc, aq[i].y * sc, aq[i].z * sc, aq[i].w * sc);
  }
}

enum Which { kDkv = 0, kDq = 1 };

// the operands, the row statistics and the gradients (K9a: dk, dv; K9b:
// dq twice)
struct BwdPtrs {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *d0, *d1;
};

template <class Kern>
cudaError_t allow_smem(Kern kern, int smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int launch_hd(Which which, const BwdPtrs& a, const BwdGeom& geo, int bf16,
              cudaStream_t stream) {
  using B16 = __nv_bfloat16;
  const dim3 grid((geo.S + kBlock - 1) / kBlock, geo.B * geo.nH);
  cudaError_t e = cudaSuccess;
  if (bf16) {
    const B16 *q = static_cast<const B16*>(a.q),
              *k = static_cast<const B16*>(a.k),
              *v = static_cast<const B16*>(a.v),
              *g = static_cast<const B16*>(a.g);
    if (which == kDkv) {
      auto kern = flash_bwd_dkv_mma_kernel<HD>;
      const int smem = Tile<HD>::kSmemDkv;
      if ((e = allow_smem(kern, smem)) == cudaSuccess)
        kern<<<grid, kThreads, smem, stream>>>(
            q, k, v, g, a.lse, a.delta, static_cast<B16*>(a.d0),
            static_cast<B16*>(a.d1), geo);
    } else {
      auto kern = flash_bwd_dq_mma_kernel<HD>;
      const int smem = Tile<HD>::kSmemDq;
      if ((e = allow_smem(kern, smem)) == cudaSuccess)
        kern<<<grid, kThreads, smem, stream>>>(
            q, k, v, g, a.lse, a.delta, static_cast<B16*>(a.d0), geo);
    }
  } else {
    const float *q = static_cast<const float*>(a.q),
                *k = static_cast<const float*>(a.k),
                *v = static_cast<const float*>(a.v),
                *g = static_cast<const float*>(a.g);
    if (which == kDkv) {
      auto kern = flash_bwd_dkv_simt_kernel<HD>;
      const int smem = 2 * kBlock * HD * 4 + 2 * kBlock * 4;
      if ((e = allow_smem(kern, smem)) == cudaSuccess)
        kern<<<grid, kSimtThreads, smem, stream>>>(
            q, k, v, g, a.lse, a.delta, static_cast<float*>(a.d0),
            static_cast<float*>(a.d1), geo);
    } else {
      auto kern = flash_bwd_dq_simt_kernel<HD>;
      const int smem = 2 * kBlock * HD * 4;
      if ((e = allow_smem(kern, smem)) == cudaSuccess)
        kern<<<grid, kSimtThreads, smem, stream>>>(
            q, k, v, g, a.lse, a.delta, static_cast<float*>(a.d0), geo);
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch(Which which, const BwdPtrs& a, const long long* strides, int B,
           int nH, int S, int hd, long long stat_row, int bf16, float scale,
           void* stream) {
  if (B < 1 || nH < 1 || S < 1 || hd % 16 || hd < 16 || hd > 128 ||
      (int64_t)B * nH > 65535 || stat_row < S || stat_row % kBlock)
    return (int)cudaErrorInvalidValue;
  BwdGeom geo = {B, nH, S, hd, {}, {}, {}, {}, {}, {}, {}, stat_row, scale};
  int64_t* dst[7] = {geo.q, geo.k, geo.v, geo.g, geo.dq, geo.dk, geo.dv};
  const int64_t elem = bf16 ? 2 : 4;
  uintptr_t align = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                    (uintptr_t)a.g | (uintptr_t)a.lse | (uintptr_t)a.delta |
                    (uintptr_t)a.d0 | (uintptr_t)a.d1;
  for (int i = 0; i < 21; ++i) {
    dst[i / 3][i % 3] = strides[i];
    align |= (uintptr_t)(strides[i] * elem);
  }
  if (align & 15) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(which, a, geo, bf16, st);
    case 32: return launch_hd<32>(which, a, geo, bf16, st);
    case 48: return launch_hd<48>(which, a, geo, bf16, st);
    case 64: return launch_hd<64>(which, a, geo, bf16, st);
    case 80: return launch_hd<80>(which, a, geo, bf16, st);
    case 96: return launch_hd<96>(which, a, geo, bf16, st);
    case 112: return launch_hd<112>(which, a, geo, bf16, st);
    case 128: return launch_hd<128>(which, a, geo, bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K9a: dk, dv of softmax(q . k^T * scale) . v for the cotangent g, all of
// shape (B, nH, S, hd), addressed by `strides`: 21 element strides,
// (batch, head, token) of q, k, v, g, dq, dk, dv in that order (dq's are
// read and not used), the head dim contiguous. lse (each row's log-sum-exp,
// natural log) and delta (rowsum(o * g)): fp32 (B nH, stat_row), stat_row a
// multiple of 64 and >= S, the first S entries of a row used. bf16 = 1:
// bf16 operands and gradients on the tensor cores; 0: fp32 on the SIMT
// body. hd a multiple of 16 up to 128; every pointer and every row 16-byte
// aligned; B nH at most 65,535. Returns cudaGetLastError() (0 = launched).
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int nH, int S, int hd, long long stat_row, int bf16,
                       float scale, void* stream) {
  return launch(kDkv, {q, k, v, g, lse, delta, dk, dv}, strides, B, nH, S,
                hd, stat_row, bf16, scale, stream);
}

// K9b: dq, with flash_attn_bwd_dkv's arguments (dk's and dv's strides read
// and not used).
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int nH,
                      int S, int hd, long long stat_row, int bf16,
                      float scale, void* stream) {
  return launch(kDq, {q, k, v, g, lse, delta, dq, dq}, strides, B, nH, S,
                hd, stat_row, bf16, scale, stream);
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
