// K8: the full-attention encoder's self-attention forward (Hopper, sm_90a),
// out = softmax(q . k^T * scale) . v over (B, nH, S, hd), no mask, every
// query against all S keys. It replaces the flash-attention forward that
// vision_instance_seg_tpu/models/pixel_decoder.py:120
// `_flash_or_dense_attention` calls on a TPU (JAX's bundled
// jax/experimental/pallas/ops/tpu/flash_attention.py:589
// `_flash_attention_impl`, pallas_call :758), in each of the 6 layers of
// `FullAttentionEncoderLayer` under SEM_SEG_HEAD.ENCODER_ATTENTION "full".
// The TPU kernel pads S to a multiple of 512 and masks the padding with
// segment ids; this one masks its ragged last key block itself.
//
// Bound, at the serving shape (B 8, nH 8, S = 100^2 + 50^2 + 25^2 =
// 13,125, hd 32, bf16): q, k, v and out are 4 x 53.8 MB = 215 MB, 0.0642
// ms at 3.35 TB/s; the two products are 4 S^2 hd B nH = 1.41 TFLOP,
// 1.4269 ms at 989 TFLOP/s on the tensor cores; the softmax takes one ex2
// per logit, S^2 B nH = 1.10e10, at 16 a clock per SM (132 SMs, ~1.98
// GHz, ~4.2e12 a second) 2.6364 ms. So the exponent unit bounds it, then
// the tensor cores; the bytes do not. Hence one pass of ex2 over each
// logit (FlashAttention-2's online softmax) and no second pass, and a
// design whose aim is to keep the exponent unit busy all the time: the
// products, the copies and the rest of the softmax run beside it.
//
// Design, bf16 (the serving path's type), after FlashAttention-3's Hopper
// forward. It replaces an earlier body (one CTA of 4 warps per 64
// queries, mma.sync m16n8k16, K and V by cp.async into a ring that every
// warp waited on at one __syncthreads() a 64-key step, so the exponent
// unit, the tensor cores and the FP32 pipe took turns):
// - One CTA per (query block, batch x head): a producer warpgroup and
//   kConsumers consumer warpgroups of 64 query rows each, three at hd <=
//   64 (192 rows; 512 threads), two above (128 rows). Grid (ceil(S /
//   rows), B nH), the query blocks of one head adjacent, so that its K and
//   V (1.7 MB at the serving shape) come from DRAM once and from L2 for
//   the other query blocks. `setmaxnreg` leaves the producer 32 registers
//   a thread (40 with two consumers) and gives each consumer 160 (232).
// - The producer: one thread of warpgroup 0 (the rest of it idles) loads
//   the CTA's Q rows once, then K and V by 128-key blocks into a ring of
//   stages (4 at hd <= 64, 3 above), each tile by one TMA copy
//   (cp.async.bulk.tensor) completing on a "full" mbarrier of its own (K
//   and V apart, so that Q K^T starts before V has landed); the consumers
//   free a stage on its "empty" mbarrier once both products have read it.
//   The consumers issue no copy and meet at no CTA barrier. The TMA map
//   (built on the host, `encode_map`, through cudaGetDriverEntryPoint)
//   views the encoder's (B, S, nH, hd) memory as five dimensions, (8
//   elements, S tokens, hd / 8 16-byte chunks, nH, B), so that its box
//   (8, rows, hd / 8, 1, 1) lands chunk by chunk: the 8 x 16-byte core
//   matrices that `gmma_desc` reads without swizzle; and as TMA bounds
//   each dimension, tokens >= S land as zeros, nothing of the next head.
// - Within a warpgroup, step j issues S_j = Q K_j^T and O += P_{j-1}
//   V_{j-1} together and waits for S_j alone: S_j's softmax runs while
//   P_{j-1} V_{j-1} is on the tensor cores; O is rescaled and P_j packed
//   once that product is done (registers: S_j 64, P_{j-1} 32, O hd / 2).
// - Across the consumer warpgroups ("pingpong", round robin with three):
//   each step's products are issued between a bar.sync on the warpgroup's
//   own named barrier and a bar.arrive on the next one's, so they issue
//   their products in turn and one's softmax (the exponent unit, the FP32
//   pipe) runs while another's products hold the tensor cores.
// - The ragged tail: 13,125 = 102 x 128 + 69, so the last key block holds
//   69 real keys (8,400 = 65 x 128 + 80 at 640 px). Keys >= S (zeros from
//   TMA) get -inf; query rows >= S (zeros) are computed and not stored.
// - Operands are addressed by (batch, head, token) strides, so the
//   encoder passes its (B, S, nH, hd) projections as (B, nH, S, hd) views
//   without a copy, and writes the output (B, S, nH, hd), ready for the
//   output projection. Rows must start 16-byte aligned.
// - Training asks for each row's log-sum-exp (a non-null `lse`): lse =
//   m scale + ln(l), natural log, from the row's max m of the raw q . k
//   and its sum l at the epilogue (JAX's `_flash_attention_fwd` :234 saves
//   l and m; here they are folded into one fp32 number), for the real rows
//   only, into (B nH) rows of `lse_row` floats. The backward (K9 in
//   flash_attn_bwd.cu) recomputes P = exp(q . k scale - lse) from it.
//   Serving passes null and runs an instance of the kernel without that
//   store (a runtime test in the epilogue cost 4% at the serving shape).
// Measured (scripts/bench_k8.py --variants, NVIDIA H100 80GB HBM3 at 700
// W, ms at the serving shape / the training shape's lse instance / 4 x
// 64): this body 4.2751-4.3014 / 0.4961-0.5005 / 3.1430-3.1510 (62% of
// the ex2 bound at the serving shape, 1.5x SDPA's speed); the earlier
// mma.sync body 6.2710-6.3789 / 0.6668-0.6763 / 5.6281-5.7247. Versions:
// one producer warp issuing 16-byte cp.async, two consumers 9.5158 /
// 0.9937 / 8.3492 (the copies set the pace); a producer warpgroup of
// cp.async, three consumers 4.7410 / 0.5498 / 3.5998; two consumers at
// every head dim 5.4322 / 0.6164 / 4.5636; no pingpong 4.9320 / 0.5669 /
// 3.1398; each step's P V done before its softmax 4.3570 / 0.5107 /
// 3.1507; 3 stages 4.3344 / 0.5036 / 3.0631; TMA's L2 promotion of 256
// bytes 4.3964 / 0.5136 / 3.4806. Timed only: K and V not loaded 4.1641 /
// 0.4873 / 2.5974, no ex2 3.8188 / 0.4521 / 3.1110. So at hd 32 neither
// the copies nor the exponent unit alone sets the pace: each warpgroup's
// chain of waits, max, ex2 and sums does, which a third consumer and the
// pingpong cover in part. 128 registers at launch with three consumers
// (168 with two), no spills at any head dim; a named barrier's id in a
// register instead of an immediate cost the consumers spills at hd 32 and
// 64.
//
// fp32: a SIMT body of the same loop, right rather than fast: 4 lanes a
// query row (each holding hd / 4 of q and of the output, as float4s
// interleaved so that a quad reads 64 contiguous bytes of a staged key),
// 64 rows a CTA, K and V tiles of 64 keys in shared memory, the online
// softmax over 8 keys at a time with exp2 (ex2.approx). The sums of p and
// of p v run in two levels: each key block's from zero, then added to the
// row's running sums, both rescaled when the max moves. One running fp32
// sum over all 13,125 keys dropped the many small terms of sharp rows
// (each under half a unit in the last place of a sum that one key
// dominates): on sharp logits (sd 3) that put this body 3.0x further from
// a float64 attention than the plain version (chip_smoke.py's "sharp
// fp32" K8 case); the same sums in fp64 brought it to 0.37x.
//
// Numerics against the plain version (kernels/flash_attention.py
// `full_attention_torch`, the JAX dense path): it rounds q * scale to bf16
// and the normalized p to bf16; K8 scales the fp32 logit and rounds the
// unnormalized p (relative to the running max of 128-key blocks) to bf16,
// as the TPU flash kernel and FlashAttention-2 do, with the row sum taken
// from fp32 p. The bf16 tolerance (2^-7 |plain| + 2^-8 max|plain|) is
// pinned on the CPU by a block-wise emulation of this rounding at 64- and
// 128-key blocks (tests/test_torch_port_full_encoder.py); fp32 is held to
// 1e-5 max|plain|. Nothing is atomic: two calls give the same bits.

#include <cuda.h>
#include <stdint.h>

#include "window_attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBlock = 64;         // fp32: query rows a CTA; keys a step
constexpr int kSimtThreads = 256;  // fp32: 4 lanes x 64 query rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// element strides of (batch, head, token) for q, k, v and out; the head
// dim is contiguous
struct FlashGeom {
  int B, nH, S, hd;
  int64_t q[3], k[3], v[3], o[3];
  float scale;
};

// training's row log-sum-exp: (B nH) rows of `row` floats, or p null
// (serving)
struct LseOut {
  float* p;
  int64_t row;
};

// The bf16 body's CTA and shared memory: the producer warpgroup and
// kConsumers warpgroups of 64 query rows; the Q tile (kRows rows), the ring
// of stages (a K tile and a V tile of kKeys keys each), then the mbarriers
// (Q's full; each stage's K full, V full and empty). A tile of R rows lies
// as TMA lands it: 16-byte chunk c of row r at c (R 16) + r 16, so the 8
// rows of a chunk are one 8 x 16-byte core matrix and a tile is, without
// swizzle, a K-major wgmma operand (Q, K: hd the K dimension; the next
// chunk R 16 bytes on, the next 8 rows 128) or an MN-major one (V: keys
// the K dimension; the next 8 keys 128 bytes on, the next chunk R 16).
// Registers: the kernel launches with 65,536 / kThreads a thread; the
// producer gives back all but kProducerRegs, which the consumers take
// (kConsumerRegs).
template <int HD>
struct Fwd {
  static constexpr int kConsumers = HD <= 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kRows = 64 * kConsumers;  // query rows a CTA
  static constexpr int kKeys = 128;              // keys a step
  static constexpr int kQTile = kRows * HD * 2;
  static constexpr int kTile = kKeys * HD * 2;   // K or V of a step
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kSmem = kQTile + 2 * kStages * kTile + 8 * kBars;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// until the phase of `bar` of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// the one arrival on `bar`, which then waits for `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: the box of `map` at (0, t0, 0, h, b) (8 elements, rows from token
// t0, every chunk, head h, batch b) into shared memory at dst, completing
// on `bar`; tokens >= S land as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int t0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %2, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(t0), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// named barrier 1 + i (i < 3) of consumer warpgroup i and the one before
// it (256 threads), its id an immediate: a register for it costs the
// consumers one of their registers
__device__ __forceinline__ void bar_sync(int i) {
  if (i == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else if (i == 1)
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(int i) {
  if (i == 0)
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  else if (i == 1)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// K8, bf16: out for kRows query rows of one (batch, head), and with kLse
// their lse (serving's instance has no such code). tq, tk, tv: the TMA
// maps of q, k and v (`encode_map`).
template <int HD, bool kLse>
__global__ void __launch_bounds__(Fwd<HD>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out, FlashGeom g,
                           LseOut lse) {
  using F = Fwd<HD>;
  constexpr int kSt = F::kStages, kWg = F::kConsumers;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * F::kRows;  // the CTA's first query token
  const int b = blockIdx.y / g.nH, h = blockIdx.y - b * g.nH;
  const int nkb = (g.S + F::kKeys - 1) / F::kKeys;
  const uint32_t qs = smem_addr(smem);
  const uint32_t ring = qs + F::kQTile;  // stage i: K at 2 i, V at 2 i + 1
  const uint32_t bars = ring + 2 * kSt * F::kTile;
  const uint32_t full_q = bars;
  auto full_k = [&](int i) { return bars + 8 * (1 + i); };
  auto full_v = [&](int i) { return bars + 8 * (1 + kSt + i); };
  auto empty = [&](int i) { return bars + 8 * (1 + 2 * kSt + i); };
  if (tid == 0) {
    mbar_init(full_q, 1);  // the producer thread's expect_tx
    for (int i = 0; i < kSt; ++i) {
      mbar_init(full_k(i), 1);
      mbar_init(full_v(i), 1);
      mbar_init(empty(i), 4 * kWg);  // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last CTA barrier: the roles split here

  if (wg == 0) {
    // the producer: one thread, Q once, then K and V of each key block
    // into stage j % kSt once the consumers have freed it (round 0 passes
    // at once)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        F::kProducerRegs));
    if (tid == 0) {
      mbar_expect(full_q, F::kQTile);
      tma_load(qs, &tq, full_q, q0, h, b);
      for (int j = 0; j < nkb; ++j) {
        const int i = j % kSt;
        mbar_wait(empty(i), ((j / kSt) & 1) ^ 1);
        const uint32_t ks = ring + 2 * i * F::kTile;
        mbar_expect(full_k(i), F::kTile);
        tma_load(ks, &tk, full_k(i), j * F::kKeys, h, b);
        mbar_expect(full_v(i), F::kTile);
        tma_load(ks + F::kTile, &tv, full_v(i), j * F::kKeys, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        F::kConsumerRegs));
    const int w = wg - 1;  // query rows 64 w .. 64 w + 63 of the CTA's
    const int wi = (tid >> 5) & 3, lane = tid & 31;
    // the thread's S fragment: rows r0, r0 + 8 of the warpgroup's 64;
    // columns 8 jj + cb, + 1 of the key block
    const int r0 = 16 * wi + (lane >> 2), cb = (lane & 3) * 2;
    const uint32_t qw = qs + w * 64 * 16;  // its rows of the Q tile
    const float sl = g.scale * kLog2e;
    float s[16][4], o[HD / 8][4];
    uint32_t pa[8][4];  // P's bf16 A fragments, k-step kk: n-tiles 2 kk, + 1
    zero(s);
    zero(o);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    auto issue_qk = [&](int j) {  // S = Q K_j^T, hd the K dimension
      const uint32_t ks = ring + 2 * (j % kSt) * F::kTile;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<16>::ss<0, 0>(
            s, gmma_desc(qw + kk * 2 * F::kRows * 16, F::kRows * 16, 128),
            gmma_desc(ks + kk * 2 * F::kKeys * 16, F::kKeys * 16, 128),
            kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // O += P V_j, keys the K dimension
      const uint32_t vs = ring + (2 * (j % kSt) + 1) * F::kTile;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        Wgmma<HD / 8>::template rs<1>(
            o, pa[kk], gmma_desc(vs + kk * 256, 128, F::kKeys * 16), 1);
      wgmma_commit();
    };
    // S_j's online softmax: s becomes p = ex2(s sl - m sl) in fp32, the
    // rows' max and sum move on; a0, a1 rescale O
    auto softmax = [&](int j, float& a0, float& a1) {
      const int real = g.S - j * F::kKeys;  // real keys in this block
      if (real < F::kKeys) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          if (8 * jj + cb >= real) s[jj][0] = s[jj][2] = -INFINITY;
          if (8 * jj + cb + 1 >= real) s[jj][1] = s[jj][3] = -INFINITY;
        }
      }
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        x0 = fmaxf(x0, fmaxf(s[jj][0], s[jj][1]));
        x1 = fmaxf(x1, fmaxf(s[jj][2], s[jj][3]));
      }
      x0 = quad_max(x0);  // finite: every block holds a real key
      x1 = quad_max(x1);
      const float u0 = x0 * sl, u1 = x1 * sl;
      a0 = exp2_approx(fmaf(m0, sl, -u0));  // 0 on the first block
      a1 = exp2_approx(fmaf(m1, sl, -u1));
      m0 = x0;
      m1 = x1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        s[jj][0] = exp2_approx(fmaf(s[jj][0], sl, -u0));
        s[jj][1] = exp2_approx(fmaf(s[jj][1], sl, -u0));
        s[jj][2] = exp2_approx(fmaf(s[jj][2], sl, -u1));
        s[jj][3] = exp2_approx(fmaf(s[jj][3], sl, -u1));
        l0 += s[jj][0] + s[jj][1];
        l1 += s[jj][2] + s[jj][3];
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        pa[jj >> 1][2 * (jj & 1)] = pack_bf16(s[jj][0], s[jj][1]);
        pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(s[jj][2], s[jj][3]);
      }
    };

    // the pingpong: warpgroup w issues its products after a bar.sync on
    // its own barrier and then lets the next one issue (bar.arrive on that
    // one's barrier); warpgroup 0 goes first. Each barrier completes as
    // often as it is waited on: the last warpgroup skips its last arrive.
    const int mine = w, next = (w + 1) % kWg;
    if (w == 0) bar_arrive(mine);
    float a0, a1;
    mbar_wait(full_q, 0);
    mbar_wait(full_k(0), 0);
    bar_sync(mine);
    wgmma_fence();
    issue_qk(0);
    bar_arrive(next);
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    softmax(0, a0, a1);
    pack_p();
    for (int j = 1; j < nkb; ++j) {
      const int prev = (j - 1) % kSt;
      mbar_wait(full_k(j % kSt), (j / kSt) & 1);
      mbar_wait(full_v(prev), ((j - 1) / kSt) & 1);
      bar_sync(mine);
      wgmma_fence();
      issue_qk(j);
      issue_pv(j - 1);
      bar_arrive(next);
      wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
      wgmma_fence_operand(s);
      softmax(j, a0, a1);
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      wgmma_fence_operand(s);
      if (lane == 0) mbar_arrive(empty(prev));  // K and V of step j - 1
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        o[dn][0] *= a0;
        o[dn][1] *= a0;
        o[dn][2] *= a1;
        o[dn][3] *= a1;
      }
      pack_p();
    }
    mbar_wait(full_v((nkb - 1) % kSt), ((nkb - 1) / kSt) & 1);
    bar_sync(mine);
    wgmma_fence();
    issue_pv(nkb - 1);
    if (w != kWg - 1) bar_arrive(next);
    wgmma_wait<0>();
    wgmma_fence_operand(o);

    // rows q0 + 64 w + r0 and + 8 as bf16 pairs (the real rows only)
    const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
    __nv_bfloat16* ob = out + b * g.o[0] + h * g.o[1] + cb;
    const int t0 = q0 + 64 * w + r0, t1 = t0 + 8;
    if constexpr (kLse) {
      if ((lane & 3) == 0) {
        float* lr = lse.p + blockIdx.y * lse.row;
        if (t0 < g.S) lr[t0] = fmaf(m0, g.scale, -logf(i0));
        if (t1 < g.S) lr[t1] = fmaf(m1, g.scale, -logf(i1));
      }
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      if (t0 < g.S)
        *reinterpret_cast<uint32_t*>(ob + t0 * g.o[2] + dn * 8) =
            pack_bf16(o[dn][0] * i0, o[dn][1] * i0);
      if (t1 < g.S)
        *reinterpret_cast<uint32_t*>(ob + t1 * g.o[2] + dn * 8) =
            pack_bf16(o[dn][2] * i1, o[dn][3] * i1);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

__device__ __forceinline__ float4 axpby4(float4 x, float a, float4 y,
                                         float p) {
  return make_float4(fmaf(x.x, a, y.x * p), fmaf(x.y, a, y.y * p),
                     fmaf(x.z, a, y.z * p), fmaf(x.w, a, y.w * p));
}

// fp32 SIMT body: lane `part` of query row `row` holds float4 number
// part + 4 i (i < HD / 16) of q and of the output accumulator
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    flash_fwd_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, FlashGeom g,
                          LseOut lse) {
  constexpr int kVec = HD / 16;  // float4s a lane
  constexpr int kRow4 = HD / 4;  // float4s a row
  extern __shared__ float4 tiles[];
  float4* ks = tiles;                    // 64 keys x HD
  float4* vs = tiles + kBlock * kRow4;   // 64 values x HD
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int b = blockIdx.y / g.nH, h = blockIdx.y - b * g.nH;
  const int t = blockIdx.x * kBlock + row;
  const bool real_row = t < g.S;
  const float* kh = k + b * g.k[0] + h * g.k[1];
  const float* vh = v + b * g.v[0] + h * g.v[1];
  const float4* qr = reinterpret_cast<const float4*>(
      q + b * g.q[0] + h * g.q[1] + (real_row ? t : 0) * g.q[2]);
  // the row's running sums of p v and p, and the key block's
  float4 qv[kVec], ov[kVec], ob[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = real_row ? qr[part + 4 * i] : make_float4(0.f, 0.f, 0.f, 0.f);
    ov[i] = ob[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float sl = g.scale * kLog2e;
  float m = -INFINITY, l = 0.f, lb = 0.f;
  for (int j0 = 0; j0 < g.S; j0 += kBlock) {
    const int nk = min(kBlock, g.S - j0);
    __syncthreads();  // every row is done with the previous tiles
    for (int c = tid; c < kBlock * kRow4; c += kSimtThreads) {
      const int r = c / kRow4, cc = c - r * kRow4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (r < nk) {
        kk = reinterpret_cast<const float4*>(kh + (j0 + r) * g.k[2])[cc];
        vv = reinterpret_cast<const float4*>(vh + (j0 + r) * g.v[2])[cc];
      }
      ks[c] = kk;
      vs[c] = vv;
    }
    __syncthreads();
    for (int u0 = 0; u0 < nk; u0 += 8) {
      float s[8];
      float mx = m;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4* kr = ks + (u0 + u) * kRow4;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc += dot4(qv[i], kr[part + 4 * i]);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        s[u] = u0 + u < nk ? acc * sl : -INFINITY;  // base-2 logits
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = exp2_approx(m - mx);  // 0 on the first keys
      m = mx;
      l *= alpha;
      lb *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ov[i] = scale4(ov[i], alpha);
        ob[i] = scale4(ob[i], alpha);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float p = exp2_approx(s[u] - mx);
        lb += p;
        const float4* vr = vs + (u0 + u) * kRow4;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          ob[i] = axpby4(ob[i], 1.f, vr[part + 4 * i], p);
      }
    }
    l += lb;  // the key block's sums into the row's
    lb = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      ov[i] = axpby4(ov[i], 1.f, ob[i], 1.f);
      ob[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (real_row) {
    if (lse.p != nullptr)  // m is in base-2 units
      lse.p[blockIdx.y * lse.row + t] = fmaf(m, kLn2, logf(l));
    const float il = 1.f / l;
    float4* orow = reinterpret_cast<float4*>(out + b * g.o[0] + h * g.o[1] +
                                             t * g.o[2]);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      orow[part + 4 * i] = make_float4(ov[i].x * il, ov[i].y * il,
                                       ov[i].z * il, ov[i].w * il);
  }
}


// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (B, nH, S, hd) bf16 view with element strides st
// (batch, head, token): five dimensions, (8 elements, S tokens, hd / 8
// chunks of 16 bytes, nH, B), and a box of (8, rows, hd / 8, 1, 1), which
// lands chunk by chunk, each chunk's rows 16 bytes apart (the core-matrix
// layout of `Fwd`). Returns 0, or a CUDA error.
int encode_map(CUtensorMap* map, const void* base, const int64_t* st,
               const FlashGeom& g, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)g.S, (cuuint64_t)(g.hd / 8),
                              (cuuint64_t)g.nH, (cuuint64_t)g.B};
  const cuuint64_t strides[4] = {(cuuint64_t)st[2] * 2, 16,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)(g.hd / 8), 1,
                             1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const FlashGeom& g, LseOut lse, int bf16, cudaStream_t stream) {
  if (bf16) {
    using F = Fwd<HD>;
    CUtensorMap tq, tk, tv;
    int err = encode_map(&tq, q, g.q, g, F::kRows);
    if (!err) err = encode_map(&tk, k, g.k, g, F::kKeys);
    if (!err) err = encode_map(&tv, v, g.v, g, F::kKeys);
    if (err) return err;
    auto kern = lse.p != nullptr ? flash_fwd_wgmma_kernel<HD, true>
                                 : flash_fwd_wgmma_kernel<HD, false>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((g.S + F::kRows - 1) / F::kRows, g.B * g.nH);
    kern<<<grid, F::kThreads, F::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), g, lse);
  } else {
    auto kern = flash_fwd_simt_kernel<HD>;
    const int smem = 2 * kBlock * HD * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((g.S + kBlock - 1) / kBlock, g.B * g.nH);
    kern<<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), g, lse);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: out = softmax(q . k^T * scale) . v for q, k, v, out of shape (B, nH,
// S, hd), addressed by `strides`: 12 element strides, (batch, head, token)
// of q, k, v and out in that order, the head dim contiguous. bf16 = 1: bf16
// operands on the tensor cores (wgmma); 0: fp32 on the SIMT body. hd a
// multiple of 16 up to 128; every pointer and every row 16-byte aligned; B
// nH at most 65,535. lse: null, or fp32 (B nH, lse_row) with lse_row >= S, which gets
// each row's log-sum-exp (natural log) in its first S entries. Returns
// cudaGetLastError() (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                   const long long* strides, int B, int nH, int S, int hd,
                   int bf16, float scale, float* lse, long long lse_row,
                   void* stream) {
  if (B < 1 || nH < 1 || S < 1 || hd % 16 || hd < 16 || hd > 128 ||
      (int64_t)B * nH > 65535 || (lse != nullptr && lse_row < S))
    return (int)cudaErrorInvalidValue;
  FlashGeom g = {B, nH, S, hd, {}, {}, {}, {}, scale};
  const LseOut lo = {lse, lse_row};
  int64_t* dst[4] = {g.q, g.k, g.v, g.o};
  const int64_t elem = bf16 ? 2 : 4;
  uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)out;
  for (int i = 0; i < 12; ++i) {
    dst[i / 3][i % 3] = strides[i];
    align |= (uintptr_t)(strides[i] * elem);
  }
  if (align & 15) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, out, g, lo, bf16, st);
    case 32: return launch_hd<32>(q, k, v, out, g, lo, bf16, st);
    case 48: return launch_hd<48>(q, k, v, out, g, lo, bf16, st);
    case 64: return launch_hd<64>(q, k, v, out, g, lo, bf16, st);
    case 80: return launch_hd<80>(q, k, v, out, g, lo, bf16, st);
    case 96: return launch_hd<96>(q, k, v, out, g, lo, bf16, st);
    case 112: return launch_hd<112>(q, k, v, out, g, lo, bf16, st);
    case 128: return launch_hd<128>(q, k, v, out, g, lo, bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
