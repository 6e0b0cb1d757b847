// Multi-scale deformable attention sampling, forward (Hopper, sm_90a).
//
// Replaces the TPU kernel _encoder_level_pallas
// (vision_instance_seg_tpu/kernels/msdeform_attn.py, entry
// ms_deform_attn_encoder_pallas / fused_ms_deform_attn). That kernel builds
// one-hot selection matrices over halo windows and multiplies them on the
// MXU because the TPU has no gather; this one gathers, so it takes any
// queries: the encoder's grid queries and a decoder's free ones.
//
// For each (b, q, head, level, point): x = loc_x * W_l - 0.5 and
// y = loc_y * H_l - 0.5; floor each and clip it to [-2, W_l] / [-2, H_l]
// before the integer cast; the four bilinear corners are read from `value`,
// a corner outside the map contributes exactly zero; the sample is weighted
// by the softmaxed attention weight and summed over levels and points in
// fp32. Output (B, Q, nH * hd) fp32.
//
// Layouts (all contiguous): value (B, S, nH, hd) fp32 or bf16 with the
// levels concatenated along S; loc (B, Q, nH, L, P, 2) fp32 normalized to
// [0, 1]; aw (B, Q, nH, L, P) fp32.
//
// Bound: memory. Per encoder layer at B = 8, 800 px (Q = S = 13,125,
// nH = 8, hd = 32, L = 3, P = 4) the call reads value once (54 MB bf16),
// loc (81 MB) and aw (40 MB) and writes out (108 MB): 282 MB, or 84 us at
// 3.35 TB/s. What the card actually moves is larger: every (query, head,
// point) reads four corner rows of hd values (64 bytes each in bf16),
// 2.6 GB per call at that shape, out of L1 and L2, where one image's value
// (6.7 MB) stays while its queries run. On the H100 the call is held back
// less by those bytes than by the instructions around them (the geometry of
// each point, the bf16 unpacking, one fp32 FMA per channel and corner) and
// by the latency of each point's loads, so the design keeps instructions
// per corner row few and warps per SM many.
//
// Design.
// - Lane groups with 16-byte loads: G = hd / V lanes take one (query,
//   head), each lane V channels (V = 8 for bf16, 4 for fp32 where the head
//   dim and the value's alignment allow, else 4, 2 or 1: the wrapper's
//   `fwd_vector_width`). A corner row is one vector load per lane, so a
//   warp instruction reads 32 / G corner rows, not one.
// - No shared memory: each lane computes its points' corner indices and
//   weights in registers (`corner_geometry`); the loc and aw loads are the
//   same address across the group. The function prefers the whole unified
//   L1 / shared memory as L1, for the corner rows that neighbouring queries
//   share.
// - The levels' loop is unrolled, so that each level's height, width and
//   start are constants of the launch: a level index held in a register
//   makes the compiler select among all of them at every point, which
//   took up to half of the call's time.
// - Latency: a point's four corner loads are issued before the first is
//   used, and the next point's loc and aw are loaded before this point
//   accumulates. One point in flight a lane, at most 64 registers (4 CTAs
//   of 256 threads, so 32 warps an SM): more points in flight cost more
//   warps than they gain (measured with scripts/bench_k1.py --variants).
// - A CTA takes `qpc` consecutive queries of one image, images on the slow
//   grid axis, so one image's value stays in L2 while its queries run.
//   Within the CTA, item i -> (query, head, lane) is query-major: a warp
//   holds the heads of neighbouring queries and reads a query's loc rows
//   contiguously (measured faster than one head of neighbouring queries a
//   warp). The wrapper's `fwd_launch_plan` chooses the grid and the CTA
//   size; its `fwd_item` states this mapping.
// - Each channel sums in the order levels, points, corners (y0, x0),
//   (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1), skipping corners off the
//   map, so the result does not depend on V or on the mapping.
// - A lane's V fp32 sums leave as 16-byte stores (8 bytes at V = 2), the
//   group's row contiguous.

#include <string.h>

#include "msdeform_attn_common.cuh"

// The largest CTA (the wrapper's FWD_MAX_THREADS; a larger one is
// refused) and the CTAs per SM its registers leave room for.
constexpr int kFwdMaxThreads = 256;
constexpr int kFwdMinBlocks = 4;

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

// V consecutive channels of one value row, read as one vector load
template <typename T, int V>
struct Chunk {
  using Raw = typename RawOf<V * (int)sizeof(T)>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    T e[V];
    memcpy(e, &raw, sizeof(raw));
    return to_float(e[j]);
  }
};

template <int V>
__device__ __forceinline__ void store_row(float* dst, const float* acc) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  } else {
    *dst = acc[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
    msdeform_attn_fwd_kernel(const T* __restrict__ value,
                             const float* __restrict__ loc,
                             const float* __restrict__ aw,
                             float* __restrict__ out, int Q, int S, int nH,
                             int hd, int L, int P, int qpc, Levels lv) {
  const int G = hd / V;
  const int C = nH * hd;
  const int LP = L * P;
  const int b = blockIdx.y;
  const int q_begin = blockIdx.x * qpc;
  const int nq = min(qpc, Q - q_begin);
  const int items = nq * nH * G;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q = i / (nH * G);
    const int h = i / G % nH;
    const int lane = i % G;
    const int64_t bqh = ((int64_t)b * Q + q_begin + q) * nH + h;
    const float2* lp = loc2 + bqh * LP;
    const float* ap = aw + bqh * LP;
    const T* vb = value + (int64_t)b * S * C + h * hd + lane * V;

    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    float2 xy = __ldg(lp);
    float a = __ldg(ap);
    // levels unrolled: their shapes are constants of the launch
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l >= L) break;
      for (int p = 0; p < P; ++p) {
        float lx, ly;
        const int4 idx = corner_geometry(xy.x, xy.y, lv, l, &lx, &ly);
        const float w0 = (1.f - ly) * (1.f - lx) * a;
        const float w1 = (1.f - ly) * lx * a;
        const float w2 = ly * (1.f - lx) * a;
        const float w3 = ly * lx * a;
        Chunk<T, V> c0, c1, c2, c3;
        if (idx.x >= 0) c0.load(vb + (int64_t)idx.x * C);
        if (idx.y >= 0) c1.load(vb + (int64_t)idx.y * C);
        if (idx.z >= 0) c2.load(vb + (int64_t)idx.z * C);
        if (idx.w >= 0) c3.load(vb + (int64_t)idx.w * C);
        // the next point's loc and aw, ahead of this point's sums
        const int next = l * P + p + 1;
        if (next < LP) {
          xy = __ldg(lp + next);
          a = __ldg(ap + next);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (idx.x >= 0) acc[j] += w0 * c0.get(j);
          if (idx.y >= 0) acc[j] += w1 * c1.get(j);
          if (idx.z >= 0) acc[j] += w2 * c2.get(j);
          if (idx.w >= 0) acc[j] += w3 * c3.get(j);
        }
      }
    }
    store_row<V>(out + bqh * hd + lane * V, acc);
  }
}

template <typename T, int V>
static int launch(const void* value, const void* loc, const void* aw,
                  void* out, int B, int S, int Q, int nH, int hd, int L,
                  int P, int qpc, int ctas, int threads, const Levels& lv,
                  cudaStream_t st) {
  auto kernel = msdeform_attn_fwd_kernel<T, V>;
  // once per instantiation: the unified L1 / shared memory all as L1
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  if (carveout != cudaSuccess) return (int)carveout;
  kernel<<<dim3(ctas, B), threads, 0, st>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<float*>(out), Q, S, nH, hd,
      L, P, qpc, lv);
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// hw holds L (height, width) pairs, level order as in `value`; `vec` is the
// channels per lane (8, 4, 2 or 1 in bf16; 4, 2 or 1 in fp32), which must
// divide hd and whose bytes must divide the value's and out's addresses;
// `queries_per_cta` consecutive queries of one image share a CTA; the grid
// is `ctas` x B CTAs of `threads` threads (the wrapper's fwd_launch_plan),
// which must cover Q and stay within kFwdMaxThreads.
int msdeform_attn_fwd(const void* value, int value_is_bf16, const void* loc,
                      const void* aw, void* out, int B, int S, int Q, int nH,
                      int hd, int L, int P, const int* hw, int vec,
                      int queries_per_cta, int ctas, int threads,
                      void* stream) {
  const int elem = value_is_bf16 ? 2 : 4;
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || nH < 1 || hd < 1 ||
      nH * hd > 1024 || queries_per_cta < 1 || vec < 1 || threads < 1 ||
      threads > kFwdMaxThreads || (int64_t)ctas * queries_per_cta < Q ||
      vec * elem > 16 || (vec & (vec - 1)) || hd % vec ||
      reinterpret_cast<uintptr_t>(value) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(out) % (vec * 4 < 16 ? vec * 4 : 16) ||
      reinterpret_cast<uintptr_t>(loc) % 8)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (fill_levels(&lv, hw, L) != S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qpc = queries_per_cta;
#define MSDA_FWD_LAUNCH(T, V)                                                 \
  return launch<T, V>(value, loc, aw, out, B, S, Q, nH, hd, L, P, qpc, \
                      ctas, threads, lv, st)
  if (value_is_bf16) {
    switch (vec) {
      case 8: MSDA_FWD_LAUNCH(__nv_bfloat16, 8);
      case 4: MSDA_FWD_LAUNCH(__nv_bfloat16, 4);
      case 2: MSDA_FWD_LAUNCH(__nv_bfloat16, 2);
      default: MSDA_FWD_LAUNCH(__nv_bfloat16, 1);
    }
  }
  switch (vec) {
    case 4: MSDA_FWD_LAUNCH(float, 4);
    case 2: MSDA_FWD_LAUNCH(float, 2);
    default: MSDA_FWD_LAUNCH(float, 1);
  }
#undef MSDA_FWD_LAUNCH
}

const char* msdeform_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
