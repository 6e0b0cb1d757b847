// Multi-scale deformable attention sampling, forward (Hopper, sm_90a).
//
// Replaces the TPU kernel _encoder_level_pallas
// (vision_instance_seg_tpu/kernels/msdeform_attn.py, entry
// ms_deform_attn_encoder_pallas / fused_ms_deform_attn). That kernel builds
// one-hot selection matrices over halo windows and multiplies them on the
// MXU because the TPU has no gather; this one gathers, so it takes any
// queries: the encoder's grid queries and, later, a decoder's free ones.
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
// 3.35 TB/s, against ~0.4 GFLOP of lerp arithmetic per image.
//
// Design for that bound. A block takes a few consecutive queries of one
// image. Phase 1: its threads read those queries' loc and aw once, coalesced
// (one (query, head, level, point) each), and turn every sampling point into
// four corner token indices (-1 off the map) and four weights (bilinear
// times attention), kept in shared memory. Phase 2: threads map to
// (head, channel), so a warp covers one head's 32 channels; for every point
// the warp reads the corner table entry as one shared-memory broadcast and
// makes four coalesced row reads of `value` (64 bytes each in bf16). Every
// output element is written once, coalesced, with no atomics. Corner rows
// are reused through L1/L2 by neighbouring queries, whose samples cluster
// around the same pixels.

#include "msdeform_attn_common.cuh"

// one sampling point: four corner token indices (-1 = off the map) and the
// four matching weights (bilinear weight times attention weight)
struct __align__(16) Corners {
  int4 idx;
  float4 w;
};

__device__ __forceinline__ Corners make_corners(float lx_, float ly_, float a,
                                                const Levels& lv, int l) {
  float lx, ly;
  Corners c;
  c.idx = corner_geometry(lx_, ly_, lv, l, &lx, &ly);
  c.w.x = (1.f - ly) * (1.f - lx) * a;
  c.w.y = (1.f - ly) * lx * a;
  c.w.z = ly * (1.f - lx) * a;
  c.w.w = ly * lx * a;
  return c;
}

template <typename T>
__global__ void msdeform_attn_fwd_kernel(const T* __restrict__ value,
                                         const float* __restrict__ loc,
                                         const float* __restrict__ aw,
                                         float* __restrict__ out, int Q,
                                         int S, int nH, int hd, int L, int P,
                                         int queries_per_block, Levels lv) {
  extern __shared__ Corners table[];  // [query][head][level * P + point]
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int C = nH * hd;
  const int LP = L * P;
  const int q_begin = blockIdx.x * queries_per_block;
  const int nq = min(queries_per_block, Q - q_begin);
  const int64_t bq0 = (int64_t)b * Q + q_begin;

  // phase 1: one (query, head, level, point) per thread, coalesced reads
  const int n_points = nq * nH * LP;
  const float2* loc2 = reinterpret_cast<const float2*>(loc) + bq0 * nH * LP;
  const float* awq = aw + bq0 * nH * LP;
  for (int i = t; i < n_points; i += blockDim.x) {
    const float2 xy = loc2[i];
    table[i] = make_corners(xy.x, xy.y, awq[i], lv, (i % LP) / P);
  }
  __syncthreads();

  // phase 2: thread = (head, channel); value[b, s, h, c] at vb + s * C
  const int h = t / hd;
  const T* vb = value + (int64_t)b * S * C + t;
  for (int qi = 0; qi < nq; ++qi) {
    const Corners* pts = table + (qi * nH + h) * LP;
    float acc = 0.f;
#pragma unroll 4
    for (int p = 0; p < LP; ++p) {
      const Corners cr = pts[p];
      if (cr.idx.x >= 0) acc += cr.w.x * to_float(vb[(int64_t)cr.idx.x * C]);
      if (cr.idx.y >= 0) acc += cr.w.y * to_float(vb[(int64_t)cr.idx.y * C]);
      if (cr.idx.z >= 0) acc += cr.w.z * to_float(vb[(int64_t)cr.idx.z * C]);
      if (cr.idx.w >= 0) acc += cr.w.w * to_float(vb[(int64_t)cr.idx.w * C]);
    }
    out[(bq0 + qi) * C + t] = acc;
  }
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// hw holds L (height, width) pairs, level order as in `value`.
int msdeform_attn_fwd(const void* value, int value_is_bf16, const void* loc,
                      const void* aw, void* out, int B, int S, int Q, int nH,
                      int hd, int L, int P, const int* hw,
                      int queries_per_block, void* stream) {
  const int point_bytes = nH * L * P * (int)sizeof(Corners);
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || nH * hd > 1024 ||
      nH * hd < 1 || point_bytes > MSDA_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (fill_levels(&lv, hw, L) != S) return (int)cudaErrorInvalidValue;
  // the corner table stays under the default 48 KB of shared memory
  int qpb = queries_per_block < 1 ? 1 : queries_per_block;
  if (qpb * point_bytes > MSDA_MAX_SMEM) qpb = MSDA_MAX_SMEM / point_bytes;
  dim3 grid((Q + qpb - 1) / qpb, B);
  dim3 block(nH * hd);
  const size_t smem = (size_t)qpb * point_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    msdeform_attn_fwd_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(aw),
        static_cast<float*>(out), Q, S, nH, hd, L, P, qpb, lv);
  } else {
    msdeform_attn_fwd_kernel<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<float*>(out), Q, S, nH, hd,
        L, P, qpb, lv);
  }
  return (int)cudaGetLastError();
}

const char* msdeform_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
