// Multi-scale deformable attention sampling, backward (Hopper, sm_90a).
//
// Replaces the three TPU backward kernels of
// vision_instance_seg_tpu/kernels/msdeform_attn.py (entry
// ms_deform_attn_encoder_bwd_pallas, reached through _encoder_pallas_diff):
// _encoder_level_bwd_lw_pallas (d(loc), d(aw) per query level),
// _encoder_bwd_v_dense_pallas (d(value) of coarse levels, dense accumulator)
// and _encoder_level_bwd_v_pallas (d(value) of fine levels, reverse-halo
// windows). The TPU splits the work into a query-centric and a value-centric
// kernel only because it has neither gather nor scatter. This card has both,
// so one fused kernel computes all three outputs for any queries and any
// offsets, and the corner geometry is computed once.
//
// Given the forward out[b, q, h*hd + c] = sum_{l, p} aw * sum_corner
// w_corner(lx, ly) * value[b, corner, h, c] and its cotangent g (B, Q, nH*hd):
//   d(aw)      = sum_corner w_corner * (g . v_corner)
//   d(loc_x)   = W_l * aw * [(1-ly)(gv01 - gv00) + ly (gv11 - gv10)]
//   d(loc_y)   = H_l * aw * [(1-lx)(gv10 - gv00) + lx (gv11 - gv01)]
//   d(value)  += aw * w_corner * g      (scattered onto the four corners)
// where gv = g . v is the dot product over the head's channels.
//
// Layouts (all contiguous): value (B, S, nH, hd) fp32 or bf16; loc
// (B, Q, nH, L, P, 2) fp32; aw (B, Q, nH, L, P) fp32; g (B, Q, nH*hd) fp32.
// Outputs: d(value) in the value's dtype through an fp32 accumulator
// (zeroed on the stream first; for fp32 values the output is the
// accumulator), d(loc) and d(aw) fp32 in the loc / aw layouts.
//
// Bound: memory. One train step's encoder layer at B = 2, 640 px
// (Q = S = 8,400, nH = 8, hd = 32, L = 3, P = 4) must read value (8.6 MB
// bf16), loc (12.9 MB), aw (6.45 MB), g (17.2 MB) and write d(value)
// (8.6 MB), d(loc) (12.9 MB) and d(aw) (6.45 MB): 73.1 MB, 22 us at
// 3.35 TB/s, against ~0.83 GFLOP (12 us at the fp32 rate). What the card
// moves is larger: every (query, head, point) reads four corner rows of the
// head's channels, as the forward does, and adds into the same four rows of
// the fp32 accumulator: 1.61 M samples x 4 corners x 128 bytes = 825 MB of
// atomic adds at that shape, served by L2, where one image's accumulator
// (8.6 MB) stays while its queries run.
//
// Design (the forward's, csrc/msdeform_attn_fwd.cu, plus the scatter):
// - Lane groups: each (query, head) takes `lanes` lanes of one warp, each
//   lane V channels of a corner row in one vector load: V = 4 (8 bytes
//   bf16, 16 fp32), narrower where the head dim or the value's address
//   needs it (the wrapper's `bwd_vector_width`). Four channels, not the
//   forward's 8 bf16: a lane's add into a d(value) row is then one 16-byte
//   fp32 vector atomic, and the group's lanes add into one contiguous run
//   of the row. At 8 bf16 channels a lane its two atomics land 16 bytes
//   apart, in twice as many 32-byte sectors of L2: 0.42 ms a call at the
//   training shape against 0.24 (scripts/bench_msdeform_bwd.py --variants,
//   NVIDIA H100 80GB HBM3 at 700 W). The head's hd / V vectors are
//   rounded up to a power of two lanes, at most 32, so that a group never
//   straddles a warp and its xor shuffles never reach another group's
//   lanes; lanes past the head's vectors idle (hd 12: 3 vectors on 4
//   lanes), and a head of more than 32 vectors gives each lane `chunks` of
//   them, vector lane + k * lanes (an unaligned value at hd 128: 4 a
//   lane). The wrapper's `bwd_launch_plan` computes lanes and chunks.
// - Each lane keeps its channels of g in registers for the whole (query,
//   head), and computes each point's corners in registers
//   (`corner_geometry`; no shared memory). The levels' loop is unrolled, so
//   that each level's shape is a constant of the launch, not a select over
//   every field of `Levels`.
// - Per point and vector: the four corner loads go out first; then the
//   d(value) adds, aw * w_corner * g, which need no value: one vector
//   atomic (red.global.add.v4.f32) per 4 channels and corner; then each
//   lane's partial g . v of each corner. The four partials are summed
//   across the group by xor shuffles (4 x log2(lanes)), which leave every
//   lane the same four sums, from which each lane forms d(aw), d(loc_x),
//   d(loc_y) in the plain version's order.
// - Lane p mod lanes keeps point p's d(loc) and d(aw); after every `lanes`
//   points the group stores them as one contiguous run.
// - A CTA takes `qpc` consecutive queries of one image (4: 256 threads at
//   8 x 32), images on the slow grid axis, items query-major as in the
//   forward (`bwd_item`). One point in flight a lane.
// - Time goes to the instructions around each point more than to the
//   atomics: without them the call takes 0.19 ms of 0.24 at the training
//   shape (same script and card).
// - d(loc) and d(aw) of a point come from one group in a fixed order, so
//   they repeat bit for bit from run to run. d(value) sums with atomics in
//   an order that changes from run to run, and so do its last bits.
// Head dims: those the TPU kernels take, any hd when nH * hd <= 128, else
// one that divides 128 (their channel chunking); hd <= 128 in both.

#include "msdeform_attn_common.cuh"

// The largest CTA (the wrapper's BWD_MAX_THREADS; a larger one is
// refused), the most channels a vector (the wrapper's BWD_MAX_VECTOR; a
// wider one is refused) and the CTAs per SM its registers leave room for:
// 3 (80 registers) at kBwdMaxVector channels a vector; 2 (128) at 2 or 1,
// whose lanes take up to 4 vectors each and spill at 80.
constexpr int kBwdMaxThreads = 256;
constexpr int kBwdMaxVector = 4;
__host__ __device__ constexpr int min_blocks(int vec) {
  return vec == kBwdMaxVector ? 3 : 2;
}

// vectors of `vec` (4, 2 or 1) channels a lane takes at most: hd <= 128
// over 32 lanes
__host__ __device__ constexpr int max_chunks(int vec) { return 4 / vec; }

// the head dims the TPU kernels take: any when nH * hd <= 128 (one lane
// chunk), else one that divides 128 (channel chunks of 128)
static inline bool msda_bwd_takes(int nH, int hd) {
  return hd >= 1 && hd <= 128 && (nH * hd <= 128 || 128 % hd == 0);
}

// dst[0 .. V) += w * g[0 .. V) as one vector atomic
template <int V>
__device__ __forceinline__ void scatter_add(float* dst, float w,
                                            const float* g) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(w * g[0], w * g[1]));
  } else {
    atomicAdd(dst, w * g[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ float dot(const float* g, const Chunk<T, V>& v) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += g[j] * v.get(j);
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdMaxThreads, min_blocks(V))
    msdeform_attn_bwd_kernel(const T* __restrict__ value,
                             const float* __restrict__ loc,
                             const float* __restrict__ aw,
                             const float* __restrict__ grad,
                             float* __restrict__ dvalue,
                             float* __restrict__ dloc,
                             float* __restrict__ daw, int Q, int S, int nH,
                             int hd, int L, int P, int lanes, int chunks,
                             int qpc, Levels lv) {
  constexpr int KMAX = max_chunks(V);
  const int G = hd / V;  // vectors of a head
  const int C = nH * hd;
  const int LP = L * P;
  const int b = blockIdx.y;
  const int q_begin = blockIdx.x * qpc;
  const int nq = min(qpc, Q - q_begin);
  const int items = nq * nH * lanes;
  // a group is `lanes` consecutive lanes of one warp, aligned to `lanes`
  const unsigned group =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << (threadIdx.x & 31 & -lanes);
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  float2* dloc2 = reinterpret_cast<float2*>(dloc);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q = i / (nH * lanes);
    const int h = i / lanes % nH;
    const int lane = i % lanes;
    const int64_t bqh = ((int64_t)b * Q + q_begin + q) * nH + h;
    const float2* lp = loc2 + bqh * LP;
    const float* ap = aw + bqh * LP;
    // value[b, s, h, c] and d(value)[b, s, h, c] at head + s * C + c
    const int64_t head = (int64_t)b * S * C + h * hd;

    // this lane's vectors k: channels [off[k], off[k] + V) of the head
    float g[KMAX][V];
    int off[KMAX];
    bool has[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = lane + k * lanes;
      has[k] = k < chunks && c < G;
      off[k] = c * V;
#pragma unroll
      for (int j = 0; j < V; ++j)
        g[k][j] = has[k] ? __ldg(grad + bqh * hd + off[k] + j) : 0.f;
    }

    float2 keep_loc = make_float2(0.f, 0.f);
    float keep_aw = 0.f;
    float2 xy = __ldg(lp);
    float a = __ldg(ap);
    // levels unrolled: their shapes are constants of the launch
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l >= L) break;
      for (int pp = 0; pp < P; ++pp) {
        const int p = l * P + pp;
        float lx, ly;
        const int4 idx = corner_geometry(xy.x, xy.y, lv, l, &lx, &ly);
        const float pa = a;
        // the next point's loc and aw, ahead of this point's work
        if (p + 1 < LP) {
          xy = __ldg(lp + p + 1);
          a = __ldg(ap + p + 1);
        }
        const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
        const float w10 = ly * (1.f - lx), w11 = ly * lx;
        const int64_t r00 = (int64_t)idx.x * C, r01 = (int64_t)idx.y * C;
        const int64_t r10 = (int64_t)idx.z * C, r11 = (int64_t)idx.w * C;
        // a vector at a time: its four corner loads go out first, then its
        // d(value) adds, which need no value, then its part of g . v (0 off
        // the map)
        float gv00 = 0.f, gv01 = 0.f, gv10 = 0.f, gv11 = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (!has[k]) continue;
          const T* vb = value + head + off[k];
          float* db = dvalue + head + off[k];
          Chunk<T, V> v00, v01, v10, v11;
          if (idx.x >= 0) v00.load(vb + r00);
          if (idx.y >= 0) v01.load(vb + r01);
          if (idx.z >= 0) v10.load(vb + r10);
          if (idx.w >= 0) v11.load(vb + r11);
          if (idx.x >= 0) scatter_add<V>(db + r00, pa * w00, g[k]);
          if (idx.y >= 0) scatter_add<V>(db + r01, pa * w01, g[k]);
          if (idx.z >= 0) scatter_add<V>(db + r10, pa * w10, g[k]);
          if (idx.w >= 0) scatter_add<V>(db + r11, pa * w11, g[k]);
          if (idx.x >= 0) gv00 += dot(g[k], v00);
          if (idx.y >= 0) gv01 += dot(g[k], v01);
          if (idx.z >= 0) gv10 += dot(g[k], v10);
          if (idx.w >= 0) gv11 += dot(g[k], v11);
        }
        // the group's sums
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          if (o >= lanes) continue;
          gv00 += __shfl_xor_sync(group, gv00, o);
          gv01 += __shfl_xor_sync(group, gv01, o);
          gv10 += __shfl_xor_sync(group, gv10, o);
          gv11 += __shfl_xor_sync(group, gv11, o);
        }
        const int slot = p & (lanes - 1);
        if (slot == lane) {
          const float d_lx = (1.f - ly) * (gv01 - gv00) + ly * (gv11 - gv10);
          const float d_ly = (1.f - lx) * (gv10 - gv00) + lx * (gv11 - gv01);
          keep_loc = make_float2((float)lv.w[l] * pa * d_lx,
                                 (float)lv.h[l] * pa * d_ly);
          keep_aw = w00 * gv00 + w01 * gv01 + w10 * gv10 + w11 * gv11;
        }
        // after every `lanes` points (and the last), one contiguous run
        if (slot == lanes - 1 || p == LP - 1) {
          const int64_t at = bqh * LP + (p - slot) + lane;
          if (lane <= slot) {
            dloc2[at] = keep_loc;
            daw[at] = keep_aw;
          }
        }
      }
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

template <typename T, int V>
static cudaError_t launch(const void* value, const void* loc, const void* aw,
                          const void* grad, float* acc, void* dloc, void* daw,
                          int B, int S, int Q, int nH, int hd, int L, int P,
                          int lanes, int chunks, int qpc, int ctas,
                          int threads, const Levels& lv, cudaStream_t st) {
  auto kernel = msdeform_attn_bwd_kernel<T, V>;
  // once per instantiation: the unified L1 / shared memory all as L1
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  if (carveout != cudaSuccess) return carveout;
  kernel<<<dim3(ctas, B), threads, 0, st>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const float*>(grad), acc,
      static_cast<float*>(dloc), static_cast<float*>(daw), Q, S, nH, hd, L,
      P, lanes, chunks, qpc, lv);
  return cudaGetLastError();
}

extern "C" {

// Zeroes dvalue_acc, launches the backward and, for bf16 values, the cast of
// the accumulator into dvalue_out, all on `stream`. Returns the first CUDA
// error (0 = ok). dvalue_acc is fp32 (B, S, nH, hd), 16-byte aligned;
// dvalue_out is ignored for fp32 values. hw holds L (height, width) pairs
// in the value's order. The plan is the wrapper's bwd_launch_plan: `vec`
// channels a vector (4, 2 or 1; it must divide hd, and its bytes the
// value's address), `lanes` (a power of two,
// at most 32) lanes a (query, head) taking `chunks` vectors each, which
// must cover hd; `queries_per_cta` consecutive queries of one image a CTA,
// `ctas` x B CTAs of `threads` threads (a multiple of `lanes`, at most
// kBwdMaxThreads), which must cover Q.
int msdeform_attn_bwd(const void* value, int value_is_bf16, const void* loc,
                      const void* aw, const void* grad, void* dvalue_acc,
                      void* dvalue_out, void* dloc, void* daw, int B, int S,
                      int Q, int nH, int hd, int L, int P, const int* hw,
                      int vec, int lanes, int chunks, int queries_per_cta,
                      int ctas, int threads, void* stream) {
  const int elem = value_is_bf16 ? 2 : 4;
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || !msda_bwd_takes(nH, hd) ||
      nH * hd > 1024 || vec < 1 || (vec & (vec - 1)) ||
      vec > kBwdMaxVector || hd % vec || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) ||
      chunks < 1 || chunks > max_chunks(vec) || lanes * chunks * vec < hd ||
      queries_per_cta < 1 || threads < 1 || threads > kBwdMaxThreads ||
      threads % lanes || (int64_t)ctas * queries_per_cta < Q ||
      reinterpret_cast<uintptr_t>(value) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(dvalue_acc) % 16 ||
      reinterpret_cast<uintptr_t>(loc) % 8 ||
      reinterpret_cast<uintptr_t>(dloc) % 8)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (fill_levels(&lv, hw, L) != S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_value = (int64_t)B * S * nH * hd;
  cudaError_t err =
      cudaMemsetAsync(dvalue_acc, 0, (size_t)n_value * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  float* acc = static_cast<float*>(dvalue_acc);
  const int qpc = queries_per_cta;
#define MSDA_BWD_LAUNCH(T, V)                                               \
  err = launch<T, V>(value, loc, aw, grad, acc, dloc, daw, B, S, Q, nH, hd, \
                     L, P, lanes, chunks, qpc, ctas, threads, lv, st);      \
  break
  if (value_is_bf16) {
    switch (vec) {
      case 4: MSDA_BWD_LAUNCH(__nv_bfloat16, 4);
      case 2: MSDA_BWD_LAUNCH(__nv_bfloat16, 2);
      default: MSDA_BWD_LAUNCH(__nv_bfloat16, 1);
    }
  } else {
    switch (vec) {
      case 4: MSDA_BWD_LAUNCH(float, 4);
      case 2: MSDA_BWD_LAUNCH(float, 2);
      default: MSDA_BWD_LAUNCH(float, 1);
    }
  }
#undef MSDA_BWD_LAUNCH
  if (err != cudaSuccess || !value_is_bf16) return (int)err;
  const int64_t blocks = (n_value + 255) / 256;
  f32_to_bf16_kernel<<<(int)(blocks < 65535 ? blocks : 65535), 256, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(dvalue_out), n_value);
  return (int)cudaGetLastError();
}

const char* msdeform_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
