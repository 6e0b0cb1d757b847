// K9: the full-attention encoder's self-attention backward (Hopper,
// sm_90a), the gradients of out = softmax(q . k^T * scale) . v over (B, nH,
// S, hd), no mask, in one pass. It replaces both kernels of the
// flash-attention backward that JAX runs under the custom_vjp of
// jax/experimental/pallas/ops/tpu/flash_attention.py:204 when
// vision_instance_seg_tpu/models/pixel_decoder.py:120
// `_flash_or_dense_attention` is differentiated on a TPU:
// `_flash_attention_bwd_dkv` (:941, pallas_call :1121) and
// `_flash_attention_bwd_dq` (:1287, pallas_call :1456), which
// `_flash_attention_bwd` (:254-311) runs one after the other. From q, k, v,
// the cotangent g = dO, each row's log-sum-exp from the forward (K8 writes
// it, flash_attn_fwd.cu) and D = rowsum(o * dO) (JAX's :273):
//   P = exp(q . k^T scale - lse),  dP = dO . v^T,  dS = P (dP - D),
//   dV = P^T dO,  dK = dS^T q scale,  dQ = dS k scale.
//
// Bound, at the training shape (B 2, nH 8, S = 80^2 + 40^2 + 20^2 = 8,400,
// hd 32, bf16): B nH S^2 = 1.13e9 logits, one ex2 each at 16 a clock per SM
// (132 SMs, ~1.98 GHz, ~4.2e12 a second): 0.27 ms. Five products (S^T,
// dP^T, dV, dK, dQ) of 2 S^2 hd a head: 0.3653 ms at 989 TFLOP/s. q, k, v,
// dO in and dQ, dK, dV out are 7 x 8.6 MB, ~0.02 ms at 3.35 TB/s. So the
// tensor cores bound it, the exponent unit nearly as much. The split pair
// this replaces did both twice (2 S^2 ex2, seven products: 0.54 ms). What
// one pass adds is dQ's sum across key blocks: each CTA adds its partial of
// each query block into an fp32 accumulator that L2 holds (8.6 MB at the
// training shape), S / 128 x S x hd x 4 bytes a head: 1.14 GB in all.
//
// Design, bf16 (the training path's type):
// - One pass, on wgmma (m64nNk16). A CTA owns 128 keys of one (batch,
//   head), two warpgroups of 64; its K and V rows stay in shared memory.
//   It loops over the query blocks of 64: S^T = K Q^T and dP^T = V dO^T
//   (both operands from shared memory, d the K dimension), then, while
//   dP^T is still on the tensor cores, P^T = ex2(s c - lse2) with c =
//   scale log2 e and lse2 = lse log2 e scaled once per row before the
//   kernel (one FFMA and one ex2 a logit); dS^T = P^T (dP^T - D). P^T and
//   dS^T are rounded to bf16 once, into registers that are at the same
//   time the A operands of dV += P^T dO and dK += dS^T Q (wgmma's register
//   A is mma.sync's A fragment of each warp's 16 rows, which is its
//   accumulator layout; dO and Q are read transposed from the same tiles)
//   and the stmatrix source of the step's dS^T tile. dK and dV stay in
//   registers.
// - dQ: after the step's one barrier, warpgroup i % 2 forms the query
//   block's partial dS K over the CTA's 128 keys (dS read transposed from
//   the dS^T tile, K from its resident tile; hd > 64 in two column parts)
//   while the other warpgroup goes on to step i + 1, then adds it into the
//   fp32 accumulator with one red.global.add.v4.f32 per lane and n-tile:
//   a warp's instruction covers 512 contiguous bytes, as the accumulator
//   is laid out in that fragment order, (B nH, stat_row / 64 query blocks,
//   parts, 4 warps, n-tiles, 32 lanes, 4). Query blocks are taken from
//   blockIdx.x on, wrapping, so that the CTAs of one head do not all add
//   into one block at once.
// - Two helpers: before K9, `flash_bwd_prep_kernel` writes lse2 and D
//   (zero past S) and zeroes the accumulator; after it,
//   `flash_bwd_dq_cast_kernel` writes dQ = accumulator * scale in bf16.
// - Shared memory holds every tile as wgmma reads it without swizzle: 8 x
//   16-byte core matrices, row r and 16-byte chunk c of a tile at (r / 8)
//   (hd * 16) + c 128 + (r % 8) 16 (8 rows of 16 bytes contiguous). So one
//   tile is both a K-major operand (d the K dimension: S^T, dP^T) and an
//   MN-major one (keys or queries the K dimension: dV, dK, dQ), and the
//   16-byte cp.async of 8 consecutive threads fill 128 contiguous bytes.
// - Loads: a ring of stages (4 at hd <= 64, 3 above) brings each query
//   block's Q and dO rows (16-byte cp.async) and its 64 lse2 and D. The one
//   barrier a step publishes the next stage (fence.proxy.async first, as
//   wgmma reads through the async proxy) and the step's dS^T, and frees
//   the previous step's stage for the load issued after it. dS^T has two
//   tiles, so that a warpgroup a step ahead stores into the other.
// - The ragged tail: 8,400 = 131 x 64 + 16 (13,125 = 205 x 64 + 5 at 800
//   px). Rows past S of every staged block are zero-filled by the copies
//   from a clamped address (the block's first row, a real one), and lse2
//   and D are zero past S: a query past S has s = 0, dP = 0, lse2 = D = 0,
//   so P = 1 and dS = 0, and it adds dO = 0 to dV, 0 to dK and its dQ row
//   lands in a padding row of the accumulator. No query is masked. Keys
//   past S are masked (P = 0) only in the CTA whose block holds the last
//   key; their dK and dV rows are not stored.
// - operands and gradients are addressed by (batch, head, token) strides:
//   the encoder passes its (B, S, nH, hd) projections and cotangent as
//   (B, nH, S, hd) views and gets dQ, dK, dV back in that layout, without a
//   transpose. Rows must start 16-byte aligned.
// Measured (scripts/bench_k9.py --variants, NVIDIA H100 80GB HBM3 at 700
// W), at the training shape, kernel alone: this body 1.09-1.11 ms; the same
// pass on mma.sync m16n8k16 (8 warps of 16 key rows, B operands through
// ldmatrix) 1.47-1.49 ms; dQ added by both warpgroups (half the columns
// each) with red.v4 1.26-1.29 ms, staged in shared memory and added by
// cp.reduce.async.bulk 1.17-1.22 ms; one warpgroup a CTA (64 keys) 1.47
// ms; each step's adds deferred to the next step 1.46 ms (ptxas then
// serializes the wgmmas). Without dQ's product and adds it takes 0.88 ms.
// 126 registers at hd 32 (2 CTAs, 16 warps an SM), 195 at 64, 254 at 128,
// no spills.
//
// fp32: the split SIMT bodies, right rather than fast, as K8's: K9a
// (`flash_bwd_dkv_simt_kernel`) owns 64 keys and loops over the query
// blocks, K9b (`flash_bwd_dq_simt_kernel`) owns 64 queries and loops over
// the key blocks; 4 lanes a row of the CTA's block (each holding hd / 4 of
// its operands and accumulators, as float4s interleaved so that a quad
// reads 64 contiguous bytes of a staged row), the other operand's block of
// 64 rows in shared memory, one row of it at a time. Nothing is atomic.
//
// Numerics against the plain version (kernels/flash_attention.py
// `flash_attention_bwd_torch`, JAX's `mha_reference_bwd` rounding for
// rounding: fp32 P, dP, dS and sums, each gradient cast once): bf16 rounds
// P and dS to bf16 before the products dV, dK and dQ, as K6 and
// FlashAttention-2 do, and sums dQ's partials of 128 keys in fp32, in an
// order that changes from run to run; the bound 2^-7 |plain| + 2^-8
// max|plain| per gradient is pinned on the CPU by a block-wise emulation
// of that rounding and order (tests/test_torch_port_full_encoder_train.py).
// dK and dV repeat bit for bit. fp32 sums in another order with ex2.approx.

#include <stdint.h>

#include "window_attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBlock = 64;         // query rows a step
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

// The fused body's shared memory: kKeys resident K and V rows, then the
// ring of stages (Q and dO rows of a query block, its lse2 and D), then two
// dS^T tiles (kKeys keys x 64 queries), all in the core-matrix layout of
// the header; dS^T's key row k and query chunk c at (k / 8) 1024 + c 128 +
// (k % 8) 16 (dQ's MN-major A).
template <int HD>
struct Fused {
  static constexpr int kThreads = 256;           // two warpgroups
  static constexpr int kKeys = 128;              // 64 a warpgroup
  static constexpr int kParts = HD <= 64 ? 1 : 2;  // dQ's column parts
  static constexpr int kQt = HD / (8 * kParts);    // their n-tiles
  static constexpr int kGroup = HD * 16;      // 8 rows, bytes
  static constexpr int kKeyTile = kKeys * HD * 2;
  static constexpr int kQTile = kBlock * HD * 2;
  static constexpr int kStatBytes = 2 * kBlock * 4;  // lse2, D of 64 rows
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  static constexpr int kStage = 2 * kQTile + kStatBytes;
  static constexpr int kDsGroup = kBlock * 16;  // 8 keys of dS^T, bytes
  static constexpr int kDsTile = kKeys * kBlock * 2;
  static constexpr int kSmem = 2 * kKeyTile + kStages * kStage + 2 * kDsTile;
};

// rows t0 .. t0 + ROWS - 1 of a head (token stride st) into a tile of the
// header's core-matrix layout, by THREADS threads, 16 bytes a piece (8
// consecutive threads: one chunk of 8 consecutive rows, 128 contiguous
// bytes); rows >= S are zeros, copied from nowhere (the source clamped to
// row t0, a real one)
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          int64_t st, int t0, int S,
                                          int tid) {
  constexpr int kChunks = HD / 8, kPieces = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kPieces + THREADS - 1) / THREADS; ++it) {
    const int c = tid + it * THREADS;
    if (kPieces % THREADS == 0 || c < kPieces) {
      const int rest = c >> 3, ch = rest % kChunks;
      const int r = (rest / kChunks) * 8 + (c & 7);
      const bool real = t0 + r < S;
      cp_async16_zfill(dst + (r >> 3) * (HD * 16) + ch * 128 + (c & 7) * 16,
                       base + (real ? t0 + r : t0) * st + ch * 8,
                       real ? 16 : 0);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// The warp's 16 rows of a gradient (a 16 x HD accumulator, times sc) to
// tokens t0 and t0 + 8 of a head (token stride st), the real ones only:
// two bf16 a store
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 8][4],
                                           float sc, __nv_bfloat16* base,
                                           int64_t st, int t0, int S) {
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(base + t0 * st + dn * 8) =
          pack_bf16(o[dn][0] * sc, o[dn][1] * sc);
    if (t0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (t0 + 8) * st + dn * 8) =
          pack_bf16(o[dn][2] * sc, o[dn][3] * sc);
  }
}

// K9, bf16: dK and dV of one block of kKeys keys, and its partials of dQ
// added into dq_acc (fp32, the header's layout).
template <int HD>
__global__ void __launch_bounds__(Fused<HD>::kThreads, HD <= 32 ? 2 : 1)
    flash_bwd_fused_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, BwdGeom geo) {
  using F = Fused<HD>;
  constexpr int kNt = HD / 8;  // n-tiles of dV, dK
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wi = (tid >> 5) & 3;  // warpgroup, its warp
  const int k0 = blockIdx.x * F::kKeys;  // the CTA's first key token
  const int bh = blockIdx.y;
  const int b = bh / geo.nH, h = bh - b * geo.nH;
  const int nqb = (geo.S + kBlock - 1) / kBlock;
  const int first = blockIdx.x % nqb;  // the query block of step 0
  const __nv_bfloat16* qh = q + b * geo.q[0] + h * geo.q[1];
  const __nv_bfloat16* gh = g + b * geo.g[0] + h * geo.g[1];
  const float* lh = lse2 + bh * geo.stat_row;
  const float* dh = delta + bh * geo.stat_row;

  const uint32_t ks = smem_addr(smem), vs = ks + F::kKeyTile;
  unsigned char* ring = smem + 2 * F::kKeyTile;
  const uint32_t dts = smem_addr(ring + F::kStages * F::kStage);
  auto block_of = [&](int i) {  // step i's query block
    const int x = first + i;
    return x >= nqb ? x - nqb : x;
  };
  auto load = [&](int i) {  // step i's Q and dO rows, lse2 and D
    const uint32_t st = smem_addr(ring + (i % F::kStages) * F::kStage);
    const int t0 = block_of(i) * kBlock;
    copy_tile<HD, kBlock, F::kThreads>(st, qh, geo.q[2], t0, geo.S, tid);
    copy_tile<HD, kBlock, F::kThreads>(st + F::kQTile, gh, geo.g[2], t0,
                                       geo.S, tid);
    if (tid < 32)
      cp_async16(st + 2 * F::kQTile + tid * 16,
                 (tid < 16 ? lh : dh) + t0 + (tid & 15) * 4);
  };
  // in the first group, with step 0's block
  copy_tile<HD, F::kKeys, F::kThreads>(ks, k + b * geo.k[0] + h * geo.k[1],
                                       geo.k[2], k0, geo.S, tid);
  copy_tile<HD, F::kKeys, F::kThreads>(vs, v + b * geo.v[0] + h * geo.v[1],
                                       geo.v[2], k0, geo.S, tid);
#pragma unroll
  for (int i = 0; i < F::kStages - 1; ++i) {
    if (i < nqb) load(i);
    cp_async_commit();
  }
  cp_async_wait<F::kStages - 2>();
  fence_proxy_async();
  __syncthreads();

  // the thread's S^T fragment: key rows r0, r0 + 8 of the CTA's block;
  // query columns 8 jj + cb, + 1 of the step's block
  const int mi = lane >> 3, cb = (lane & 3) * 2;
  const int r0 = 64 * wg + 16 * wi + (lane >> 2);
  const bool tail = k0 + F::kKeys > geo.S;  // keys past S in this block
  const bool kr0 = k0 + r0 < geo.S, kr1 = k0 + r0 + 8 < geo.S;
  const float c2 = geo.scale * kLog2e;
  // the warpgroup's 64 K and V rows (S^T's and dP^T's A)
  const uint32_t kw = ks + wg * 8 * F::kGroup, vw = vs + wg * 8 * F::kGroup;
  // its rows of dS^T's tile (stmatrix: matrix mi, row lane % 8)
  const uint32_t dsw = ((64 * wg + 16 * wi + 8 * (mi & 1)) / 8) * F::kDsGroup +
                       (mi >> 1) * 128 + (lane & 7) * 16;
  float adk[kNt][4], adv[kNt][4];
  zero(adk);
  zero(adv);
  for (int i = 0; i < nqb; ++i) {
    const unsigned char* sp = ring + (i % F::kStages) * F::kStage;
    const uint32_t qs = smem_addr(sp), gs = qs + F::kQTile;
    const float* ls = reinterpret_cast<const float*>(sp + 2 * F::kQTile);
    const float* ds = ls + kBlock;
    const uint32_t dst = dts + (i & 1) * F::kDsTile;

    // S^T = K Q^T and dP^T = V dO^T: K-major A and B, d the K dimension
    float st[8][4], dpt[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<8>::ss<0, 0>(st, gmma_desc(kw + kk * 256, 128, F::kGroup),
                         gmma_desc(qs + kk * 256, 128, F::kGroup), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<8>::ss<0, 0>(dpt, gmma_desc(vw + kk * 256, 128, F::kGroup),
                         gmma_desc(gs + kk * 256, 128, F::kGroup), kk > 0);
    wgmma_commit();
    // P^T = ex2(s c - lse2) while dP^T is on the tensor cores
    wgmma_wait<1>();
    wgmma_fence_operand(st);
    uint32_t pa[4][4], da[4][4];  // n-tiles 2 kk, 2 kk + 1: k-step kk's A
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 e = *reinterpret_cast<const float2*>(ls + 8 * jj + cb);
      st[jj][0] = exp2_approx(fmaf(st[jj][0], c2, -e.x));
      st[jj][1] = exp2_approx(fmaf(st[jj][1], c2, -e.y));
      st[jj][2] = exp2_approx(fmaf(st[jj][2], c2, -e.x));
      st[jj][3] = exp2_approx(fmaf(st[jj][3], c2, -e.y));
      if (tail) {
        if (!kr0) st[jj][0] = st[jj][1] = 0.f;
        if (!kr1) st[jj][2] = st[jj][3] = 0.f;
      }
      pa[jj >> 1][2 * (jj & 1)] = pack_bf16(st[jj][0], st[jj][1]);
      pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(st[jj][2], st[jj][3]);
    }
    // dS^T = P^T (dP^T - D)
    wgmma_wait<0>();
    wgmma_fence_operand(dpt);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d = *reinterpret_cast<const float2*>(ds + 8 * jj + cb);
      da[jj >> 1][2 * (jj & 1)] = pack_bf16(st[jj][0] * (dpt[jj][0] - d.x),
                                            st[jj][1] * (dpt[jj][1] - d.y));
      da[jj >> 1][2 * (jj & 1) + 1] =
          pack_bf16(st[jj][2] * (dpt[jj][2] - d.x),
                    st[jj][3] * (dpt[jj][3] - d.y));
    }
    // dV += P^T dO, dK += dS^T Q: A from registers, dO and Q MN-major B
    // (queries the K dimension)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<kNt>::template rs<1>(
          adv, pa[kk], gmma_desc(gs + kk * 2 * F::kGroup, F::kGroup, 128), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<kNt>::template rs<1>(
          adk, da[kk], gmma_desc(qs + kk * 2 * F::kGroup, F::kGroup, 128), 1);
    wgmma_commit();
    // dS^T to its tile, 8 x 8 blocks
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) stsm_x4(dst + dsw + kk * 256, da[kk]);
    cp_async_wait<F::kStages - 3>();  // step i + 1's block has landed (this
    fence_proxy_async();  // thread's pieces), for wgmma as its dS^T stores
    __syncthreads();  // ... everyone's, and every dS^T row of step i; every
                      // wgmma of step i - 1 is done with its stage
    if (i + F::kStages - 1 < nqb) load(i + F::kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact

    // the dQ partial of the query block, by warpgroup i % 2 while the other
    // goes on to step i + 1: dS (MN-major A, keys the K dimension) times K
    // (MN-major B), over the CTA's keys, in kParts column parts, each added
    // into the accumulator's run for this query block (fragment order: a
    // warp's red.v4 covers 512 contiguous bytes)
    if ((i & 1) == wg) {
      float* acc = dq_acc + (bh * (geo.stat_row / kBlock) + block_of(i)) *
                                (kBlock * HD) +
                   lane * 4;
#pragma unroll
      for (int part = 0; part < F::kParts; ++part) {
        float adq[F::kQt][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < F::kKeys / 16; ++kk)
          Wgmma<F::kQt>::template ss<1, 1>(
              adq, gmma_desc(dst + kk * 2 * F::kDsGroup, F::kDsGroup, 128),
              gmma_desc(ks + kk * 2 * F::kGroup + part * F::kQt * 128,
                        F::kGroup, 128),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(adq);
        wgmma_fence_operand(adk);
        wgmma_fence_operand(adv);
#pragma unroll
        for (int dn = 0; dn < F::kQt; ++dn)
          atomicAdd(reinterpret_cast<float4*>(
                        acc + ((part * 4 + wi) * F::kQt + dn) * 128),
                    make_float4(adq[dn][0], adq[dn][1], adq[dn][2],
                                adq[dn][3]));
      }
    } else {
      wgmma_wait<0>();  // dV, dK
      wgmma_fence_operand(adk);
      wgmma_fence_operand(adv);
    }
  }

  const int t0 = k0 + r0;
  store_rows<HD>(adk, geo.scale, dk + b * geo.dk[0] + h * geo.dk[1] + cb,
                 geo.dk[2], t0, geo.S);
  store_rows<HD>(adv, 1.f, dv + b * geo.dv[0] + h * geo.dv[1] + cb,
                 geo.dv[2], t0, geo.S);
}

// Before K9, bf16: thread (row t of head bh) writes lse2 = lse log2 e and
// D = rowsum(o * dO) (fp32 products of the bf16 pairs, summed in fp32) of
// its row, zeros past S, and zeroes the row of the dQ accumulator.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ g,
                          const float* __restrict__ lse, int64_t lse_b,
                          int64_t lse_h, float* __restrict__ lse2,
                          float* __restrict__ delta,
                          float* __restrict__ dq_acc, BwdGeom geo) {
  const int64_t rows = (int64_t)geo.B * geo.nH * geo.stat_row;
  const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= rows) return;
  const int bh = (int)(x / geo.stat_row), t = (int)(x % geo.stat_row);
  const int b = bh / geo.nH, h = bh - b * geo.nH;
  float e = 0.f, d = 0.f;
  if (t < geo.S) {
    const uint4* orow = reinterpret_cast<const uint4*>(
        o + b * geo.q[0] + h * geo.q[1] + t * geo.q[2]);
    const uint4* grow = reinterpret_cast<const uint4*>(
        g + b * geo.g[0] + h * geo.g[1] + t * geo.g[2]);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 ov = orow[c], gv = grow[c];
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(op[j]),
                     gf = __bfloat1622float2(gp[j]);
        d = fmaf(of.x, gf.x, d);
        d = fmaf(of.y, gf.y, d);
      }
    }
    e = lse[b * lse_b + h * lse_h + t] * kLog2e;
  }
  lse2[x] = e;
  delta[x] = d;
  float4* arow = reinterpret_cast<float4*>(dq_acc + x * HD);
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) arow[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// After K9, bf16: dQ = the accumulator times scale, cast to bf16, into the
// (batch, head, token) strided gradient; thread x takes the accumulator's
// float4 number x (one lane's n-tile: rows r, r + 8, columns c, c + 1).
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc,
                             __nv_bfloat16* __restrict__ dq, BwdGeom geo) {
  using F = Fused<HD>;
  constexpr int kPart = 4 * F::kQt * 32;  // float4s of a column part
  const int64_t per_head = geo.stat_row * HD / 4;
  const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= geo.B * geo.nH * per_head) return;
  const int bh = (int)(x / per_head);
  const int f = (int)(x % per_head);
  const int blk = f / (16 * HD), y = f % (16 * HD);
  const int part = y / kPart, z = y % kPart;
  const int wi = z / (F::kQt * 32), dn = (z / 32) % F::kQt, lane = z % 32;
  const int t = blk * kBlock + wi * 16 + (lane >> 2);
  const int col = part * (HD / F::kParts) + dn * 8 + (lane & 3) * 2;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[x];
  const int b = bh / geo.nH, h = bh - b * geo.nH;
  __nv_bfloat16* base = dq + b * geo.dq[0] + h * geo.dq[1] + col;
  if (t < geo.S)
    *reinterpret_cast<uint32_t*>(base + t * geo.dq[2]) =
        pack_bf16(a.x * geo.scale, a.y * geo.scale);
  if (t + 8 < geo.S)
    *reinterpret_cast<uint32_t*>(base + (t + 8) * geo.dq[2]) =
        pack_bf16(a.z * geo.scale, a.w * geo.scale);
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

// the operands, the row statistics and the outputs (bf16: dq_acc, dk, dv;
// fp32 K9a: dk, dv; fp32 K9b: dq; prep: q is o, lse and delta are lse2
// and D, d0 dq_acc, d1 the forward's lse; cast: d0 dq_acc, d1 dq)
struct BwdPtrs {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *d0, *d1, *d2;
  int64_t lse_b, lse_h;  // prep: the forward lse's strides
};

enum Which { kFused = 0, kDkv = 1, kDq = 2, kPrep = 3, kCast = 4 };

template <class Kern>
cudaError_t allow_smem(Kern kern, int smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int launch_hd(Which which, const BwdPtrs& a, const BwdGeom& geo,
              cudaStream_t stream) {
  using B16 = __nv_bfloat16;
  cudaError_t e = cudaSuccess;
  if (which == kPrep || which == kCast) {
    const int64_t n = which == kPrep
                          ? (int64_t)geo.B * geo.nH * geo.stat_row
                          : (int64_t)geo.B * geo.nH * geo.stat_row * HD / 4;
    const dim3 grid((unsigned)((n + 255) / 256));
    if (which == kPrep)
      flash_bwd_prep_kernel<HD><<<grid, 256, 0, stream>>>(
          static_cast<const B16*>(a.q), static_cast<const B16*>(a.g),
          static_cast<const float*>(a.d1), a.lse_b, a.lse_h,
          const_cast<float*>(a.lse), const_cast<float*>(a.delta),
          static_cast<float*>(a.d0), geo);
    else
      flash_bwd_dq_cast_kernel<HD><<<grid, 256, 0, stream>>>(
          static_cast<const float*>(a.d0), static_cast<B16*>(a.d1), geo);
  } else if (which == kFused) {
    using F = Fused<HD>;
    const dim3 grid((geo.S + F::kKeys - 1) / F::kKeys, geo.B * geo.nH);
    auto kern = flash_bwd_fused_kernel<HD>;
    if ((e = allow_smem(kern, F::kSmem)) == cudaSuccess)
      kern<<<grid, F::kThreads, F::kSmem, stream>>>(
          static_cast<const B16*>(a.q), static_cast<const B16*>(a.k),
          static_cast<const B16*>(a.v), static_cast<const B16*>(a.g), a.lse,
          a.delta, static_cast<float*>(a.d0), static_cast<B16*>(a.d1),
          static_cast<B16*>(a.d2), geo);
  } else {
    const dim3 grid((geo.S + kBlock - 1) / kBlock, geo.B * geo.nH);
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
           int nH, int S, int hd, long long stat_row, float scale,
           void* stream) {
  if (B < 1 || nH < 1 || S < 1 || hd % 16 || hd < 16 || hd > 128 ||
      (int64_t)B * nH > 65535 || stat_row < S || stat_row % kBlock)
    return (int)cudaErrorInvalidValue;
  BwdGeom geo = {B, nH, S, hd, {}, {}, {}, {}, {}, {}, {}, stat_row, scale};
  int64_t* dst[7] = {geo.q, geo.k, geo.v, geo.g, geo.dq, geo.dk, geo.dv};
  const int64_t elem = which == kDkv || which == kDq ? 4 : 2;
  uintptr_t align = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                    (uintptr_t)a.g | (uintptr_t)a.lse | (uintptr_t)a.delta |
                    (uintptr_t)a.d0 | (uintptr_t)a.d1 | (uintptr_t)a.d2;
  for (int i = 0; i < 21; ++i) {
    dst[i / 3][i % 3] = strides[i];
    align |= (uintptr_t)(strides[i] * elem);
  }
  if (align & 15) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(which, a, geo, st);
    case 32: return launch_hd<32>(which, a, geo, st);
    case 48: return launch_hd<48>(which, a, geo, st);
    case 64: return launch_hd<64>(which, a, geo, st);
    case 80: return launch_hd<80>(which, a, geo, st);
    case 96: return launch_hd<96>(which, a, geo, st);
    case 112: return launch_hd<112>(which, a, geo, st);
    case 128: return launch_hd<128>(which, a, geo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K9, bf16: dk, dv of softmax(q . k^T * scale) . v for the cotangent g, all
// of shape (B, nH, S, hd), addressed by `strides`: 21 element strides,
// (batch, head, token) of q, k, v, g, dq, dk, dv in that order (dq's are
// read and not used), the head dim contiguous; and dQ / scale added into
// dq_acc, fp32 (B nH, stat_row, hd) zeroed by the caller, in the fragment
// order of the header. lse2 (each row's log-sum-exp times log2 e) and delta
// (rowsum(o * g)): fp32 (B nH, stat_row), stat_row a multiple of 64 and >=
// S, zero past S. hd a multiple of 16 up to 128; every pointer and every
// row 16-byte aligned; B nH at most 65,535. Returns cudaGetLastError() (0 =
// launched).
int flash_attn_bwd(const void* q, const void* k, const void* v,
                   const void* g, const float* lse2, const float* delta,
                   float* dq_acc, void* dk, void* dv,
                   const long long* strides, int B, int nH, int S, int hd,
                   long long stat_row, float scale, void* stream) {
  return launch(kFused, {q, k, v, g, lse2, delta, dq_acc, dk, dv}, strides,
                B, nH, S, hd, stat_row, scale, stream);
}

// Before flash_attn_bwd: from o (q's strides) and the cotangent g, both
// bf16, and the forward's lse (fp32, element strides lse_b, lse_h of batch
// and head, tokens contiguous) write lse2 and delta ((B nH, stat_row) fp32,
// zero past S) and zero dq_acc.
int flash_attn_bwd_prep(const void* o, const void* g, const float* lse,
                        long long lse_b, long long lse_h, float* lse2,
                        float* delta, float* dq_acc,
                        const long long* strides, int B, int nH, int S,
                        int hd, long long stat_row, void* stream) {
  BwdPtrs a = {o, nullptr, nullptr, g, lse2, delta, dq_acc,
               const_cast<float*>(lse), nullptr, lse_b, lse_h};
  return launch(kPrep, a, strides, B, nH, S, hd, stat_row, 1.f, stream);
}

// After flash_attn_bwd: dq (bf16, dq's strides) = dq_acc * scale.
int flash_attn_bwd_dq_cast(const float* dq_acc, void* dq,
                           const long long* strides, int B, int nH, int S,
                           int hd, long long stat_row, float scale,
                           void* stream) {
  BwdPtrs a = {dq, dq, dq, dq, dq_acc, dq_acc, const_cast<float*>(dq_acc),
               dq, nullptr, 0, 0};
  return launch(kCast, a, strides, B, nH, S, hd, stat_row, scale, stream);
}

// K9a, fp32: dk, dv with flash_attn_bwd's arguments, but fp32 operands and
// gradients and lse the natural log-sum-exp (padding not read).
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int nH, int S, int hd, long long stat_row, float scale,
                       void* stream) {
  return launch(kDkv, {q, k, v, g, lse, delta, dk, dv, dv}, strides, B, nH,
                S, hd, stat_row, scale, stream);
}

// K9b, fp32: dq, with flash_attn_bwd_dkv's arguments (dk's and dv's strides
// read and not used).
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int nH,
                      int S, int hd, long long stat_row, float scale,
                      void* stream) {
  return launch(kDq, {q, k, v, g, lse, delta, dq, dq, dq}, strides, B, nH, S,
                hd, stat_row, scale, stream);
}

// The keys a CTA of flash_attn_bwd (each adds one partial of every query
// block into dq_acc).
int flash_attn_bwd_block_keys() { return Fused<32>::kKeys; }

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
