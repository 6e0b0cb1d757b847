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
// 13,125, hd 32, bf16): q, k, v and out are 4 x 53.8 MB = 215 MB, 0.064 ms
// at 3.35 TB/s; the two products are 4 S^2 hd B nH = 1.41 TFLOP, 1.43 ms
// at 989 TFLOP/s on the tensor cores; the softmax takes one ex2 per logit,
// S^2 B nH = 1.10e10, at 16 a clock per SM (132 SMs, ~1.98 GHz, ~4.2e12
// a second) ~2.6 ms. So the exponent unit bounds it, then the tensor
// cores; the bytes do not. Hence one pass of ex2 over each logit
// (FlashAttention-2's online softmax) and no second pass.
//
// Design, bf16 (the serving path's type), on mma.sync m16n8k16 with the
// building blocks of window_attn_mma.cuh:
// - one CTA of 4 warps per (64-row query block, batch x head): grid
//   (ceil(S / 64), B nH), the query blocks of one head adjacent, so that
//   its K and V (1.7 MB at the serving shape) come from DRAM once and from
//   L2 for the other query blocks;
// - the Q block is staged once and held as A fragments in registers; a
//   loop over the ceil(S / 64) key blocks copies K and V by 16-byte
//   cp.async into a ring of stages (3 at hd <= 64, 2 above), one barrier a
//   step;
// - a step: S = Q K^T over the block (fp32 accumulators), the online
//   softmax of wa_online_softmax (fp32 running max and sum, log2(e) scale
//   folded into one fma before each ex2, O rescaled when the max moves),
//   P unnormalized in bf16 as the A fragment of O += P V; O *= 1 / l at
//   the end, rounded once to bf16;
// - the ragged tail: 13,125 = 205 x 64 + 5, so the last key block holds 5
//   real keys (8,400 = 131 x 64 + 16 at 640 px). Keys >= S get -inf; rows
//   >= S of K, V and Q are zero-filled by the copies from a clamped
//   address (the block's first row, a real one), and query rows >= S are
//   computed and not stored;
// - operands are addressed by (batch, head, token) strides, so the
//   encoder passes its (B, S, nH, hd) projections as (B, nH, S, hd) views
//   without a copy, and writes the output (B, S, nH, hd), ready for the
//   output projection. Rows must start 16-byte aligned.
// - training asks for each row's log-sum-exp (a non-null `lse`): lse =
//   m scale + ln(l), natural log, from the row's max m of the raw q . k
//   and its sum l at the epilogue (JAX's `_flash_attention_fwd` :234 saves
//   l and m; here they are folded into one fp32 number), for the real rows
//   only, into (B nH) rows of `lse_row` floats. The backward (K9a, K9b in
//   flash_attn_bwd.cu) recomputes P = exp(q . k scale - lse) from it.
//   Serving passes null and runs an instance of the kernel without that
//   store (a runtime test in the epilogue cost 4% at the serving shape).
// No wgmma, TMA or warp specialisation yet.
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
// unnormalized p (relative to the running max) to bf16, as the TPU flash
// kernel and FlashAttention-2 do, with the row sum taken from fp32 p. The
// bf16 tolerance (2^-7 |plain| + 2^-8 max|plain|) is pinned on the CPU by
// a block-wise emulation of this rounding (tests/test_torch_port_full_
// encoder.py); fp32 is held to 1e-5 max|plain|.

#include <stdint.h>

#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kBlock = 64;     // query rows per CTA; keys per step
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

template <int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;              // 16-byte pieces a row
  static constexpr int kPitch = HD * 2 + 16;          // staged row, bytes
  static constexpr int kTileBytes = kBlock * kPitch;  // 64 rows
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kSmem = kTileBytes + kStages * 2 * kTileBytes;
};

// kLse: store each row's lse (serving's instance has no such code)
template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, FlashGeom g,
                         LseOut lse) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock;  // the CTA's first query token
  const int b = blockIdx.y / g.nH, h = blockIdx.y - b * g.nH;
  const int nkb = (g.S + kBlock - 1) / kBlock;
  const __nv_bfloat16* qh = q + b * g.q[0] + h * g.q[1];
  const __nv_bfloat16* kh = k + b * g.k[0] + h * g.k[1];
  const __nv_bfloat16* vh = v + b * g.v[0] + h * g.v[1];

  // the thread's 16-byte pieces of a 64-row tile: c = tid + 128 it, at row
  // c / (HD / 8), piece c % (HD / 8)
  int trow[HD / 16], soff[HD / 16], gcol[HD / 16];
#pragma unroll
  for (int it = 0; it < HD / 16; ++it) {
    const int c = tid + it * kThreads;
    trow[it] = c / T::kChunks;
    soff[it] = trow[it] * T::kPitch + (c % T::kChunks) * 16;
    gcol[it] = (c % T::kChunks) * 8;
  }
  // rows t0 .. t0 + 63 of a head into a tile; rows >= S are zeros, copied
  // from nowhere (the source clamped to row t0, a real one)
  auto copy_tile = [&](uint32_t dst, const __nv_bfloat16* base, int64_t st,
                       int t0) {
#pragma unroll
    for (int it = 0; it < HD / 16; ++it) {
      const int t = t0 + trow[it];
      const bool real = t < g.S;
      cp_async16_zfill(dst + soff[it],
                       base + (real ? t : t0) * st + gcol[it],
                       real ? 16 : 0);
    }
  };
  const uint32_t qs = smem_addr(smem);
  auto stage = [&](int j) {
    return qs + T::kTileBytes + (j % T::kStages) * 2 * T::kTileBytes;
  };
  auto load_kv = [&](int j) {
    const uint32_t st = stage(j);
    copy_tile(st, kh, g.k[2], j * kBlock);
    copy_tile(st + T::kTileBytes, vh, g.v[2], j * kBlock);
  };
  copy_tile(qs, qh, g.q[2], q0);  // in the first group, with key block 0
#pragma unroll
  for (int j = 0; j < T::kStages - 1; ++j) {
    if (j < nkb) load_kv(j);
    cp_async_commit();
  }

  const float sl = g.scale * kLog2e;
  // the thread's S fragment: rows r0, r0 + 8 of the query block; columns
  // 8 jj + cb, + 1 of the key block
  const int r0 = warp * 16 + (lane >> 2), cb = (lane & 3) * 2;
  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<T::kStages - 2>();  // key block j has landed (this
    __syncthreads();  // thread's; now everyone's), and every warp is past
                      // step j - 1, whose stage the next load reuses
    if (j + T::kStages - 1 < nkb) load_kv(j + T::kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact
    if (j == 0) wa_load_q<HD>(qa, qs, T::kPitch, warp, lane);
    const uint32_t ks = stage(j), vs = ks + T::kTileBytes;

    float sc[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
    wa_qk_block<HD>(sc, qa, ks, T::kPitch, lane);
    const int real = g.S - j * kBlock;  // real keys in this block
    if (real < kBlock) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (8 * jj + cb >= real) sc[jj][0] = sc[jj][2] = -INFINITY;
        if (8 * jj + cb + 1 >= real) sc[jj][1] = sc[jj][3] = -INFINITY;
      }
    }
    wa_online_softmax<HD>(sc, o, sl, m0, m1, l0, l1);
    wa_pv_block<HD>(o, sc, 1.f, 1.f, vs, T::kPitch, lane);  // P unnormalized
  }

  // rows q0 + r0 and q0 + r0 + 8 as bf16 pairs (the real rows only)
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
  __nv_bfloat16* ob = out + b * g.o[0] + h * g.o[1] + cb;
  const int t0 = q0 + r0, t1 = t0 + 8;
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

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const FlashGeom& g, LseOut lse, int bf16, cudaStream_t stream) {
  const dim3 grid((g.S + kBlock - 1) / kBlock, g.B * g.nH);
  if (bf16) {
    auto kern = lse.p != nullptr ? flash_fwd_mma_kernel<HD, true>
                                 : flash_fwd_mma_kernel<HD, false>;
    const int smem = Tile<HD>::kSmem;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), g, lse);
  } else {
    auto kern = flash_fwd_simt_kernel<HD>;
    const int smem = 2 * kBlock * HD * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
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
// operands on the tensor cores; 0: fp32 on the SIMT body. hd a multiple of
// 16 up to 128; every pointer and every row 16-byte aligned; B nH at most
// 65,535. lse: null, or fp32 (B nH, lse_row) with lse_row >= S, which gets
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
