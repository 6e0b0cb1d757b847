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
// 3.35 TB/s, against ~0.83 GFLOP (12 us at the fp32 rate). The simple design
// below also issues 1.61 M samples x 4 corners x 32 channels = 206 M fp32
// atomic adds into d(value), which are likely to set its time.
//
// Design. A block takes a few consecutive queries of one image. Phase 1:
// one (query, head, level, point) per thread turns loc into corner indices
// and fractional offsets in shared memory (coalesced reads of loc and aw).
// Phase 2: each head takes `lanes` threads, the next power of two >= hd and
// at most 32, so that a head's lanes sit in one warp; lane i takes channels
// i, i + lanes, ... below hd (at most 4: hd <= 128). For every point each
// lane reads its channels of the four corner rows and of g, sums its own
// channels' terms of d(aw), d(lx) and d(ly), reduces the three sums across
// the head's lanes with xor shuffles, and atomically adds aw * w_corner * g
// into the fp32 d(value) rows, one atomic per channel and corner. The
// head's lane 0 parks d(loc) and d(aw) in shared memory. Phase 3 writes them
// coalesced. The atomics make d(value)'s summation order, and so its last
// bits, vary from run to run. Head dims: those the TPU kernels take, any hd
// when nH * hd <= 128, else one that divides 128 (their channel chunking).

#include "msdeform_attn_common.cuh"

// one sampling point: corner token indices (-1 = off the map), the
// fractional offsets and the attention weight
struct __align__(16) BwdPoint {
  int4 idx;
  float4 f;  // lx, ly, aw, unused
};

// bytes of shared memory per (query, head, level, point)
#define MSDA_BWD_POINT_BYTES ((int)sizeof(BwdPoint) + 3 * (int)sizeof(float))
// channels of one head a lane takes: hd <= 128 over 32 lanes
#define MSDA_BWD_MAX_CHANNELS_PER_LANE 4

// threads per head: the next power of two >= hd, at most 32
__host__ __device__ __forceinline__ int msda_bwd_lanes(int hd) {
  int lanes = 1;
  while (lanes < hd && lanes < 32) lanes <<= 1;
  return lanes;
}

// the head dims the TPU kernels take: any when nH * hd <= 128 (one lane
// chunk), else one that divides 128 (channel chunks of 128)
static inline bool msda_bwd_takes(int nH, int hd) {
  return hd >= 1 && hd <= 128 && (nH * hd <= 128 || 128 % hd == 0);
}

template <typename T>
__global__ void msdeform_attn_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ aw, const float* __restrict__ grad,
    float* __restrict__ dvalue, float* __restrict__ dloc,
    float* __restrict__ daw, int Q, int S, int nH, int hd, int L, int P,
    int queries_per_block, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int C = nH * hd;
  const int LP = L * P;
  const int q_begin = blockIdx.x * queries_per_block;
  const int nq = min(queries_per_block, Q - q_begin);
  const int64_t bq0 = (int64_t)b * Q + q_begin;
  const int n_points = nq * nH * LP;
  BwdPoint* table = reinterpret_cast<BwdPoint*>(smem);
  float2* res_loc =
      reinterpret_cast<float2*>(table + queries_per_block * nH * LP);
  float* res_aw = reinterpret_cast<float*>(res_loc + queries_per_block * nH * LP);

  // phase 1: one (query, head, level, point) per thread, coalesced reads
  const float2* loc2 = reinterpret_cast<const float2*>(loc) + bq0 * nH * LP;
  const float* awq = aw + bq0 * nH * LP;
  for (int i = t; i < n_points; i += blockDim.x) {
    const float2 xy = loc2[i];
    BwdPoint pt;
    pt.idx = corner_geometry(xy.x, xy.y, lv, (i % LP) / P, &pt.f.x, &pt.f.y);
    pt.f.z = awq[i];
    pt.f.w = 0.f;
    table[i] = pt;
  }
  __syncthreads();

  // phase 2: `lanes` threads per head; value[b, s, h, c] at vb + s * C + c
  const int lanes = msda_bwd_lanes(hd);
  const int h = t / lanes;
  const int li = t - h * lanes;
  const int warp_lanes = min(32, (int)blockDim.x - (t & ~31));
  const unsigned mask =
      warp_lanes == 32 ? 0xffffffffu : ((1u << warp_lanes) - 1u);
  const T* vb = value + (int64_t)b * S * C + h * hd;
  float* dvb = dvalue + (int64_t)b * S * C + h * hd;
  for (int qi = 0; qi < nq; ++qi) {
    float g[MSDA_BWD_MAX_CHANNELS_PER_LANE];  // this lane's channels of g
#pragma unroll
    for (int k = 0; k < MSDA_BWD_MAX_CHANNELS_PER_LANE; ++k) {
      const int c = li + k * lanes;
      g[k] = c < hd ? grad[(bq0 + qi) * C + h * hd + c] : 0.f;
    }
    const int row = (qi * nH + h) * LP;
    for (int p = 0; p < LP; ++p) {
      const BwdPoint pt = table[row + p];
      const float lx = pt.f.x, ly = pt.f.y, a = pt.f.z;
      const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
      const float w10 = ly * (1.f - lx), w11 = ly * lx;
      float s_aw = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int k = 0; k < MSDA_BWD_MAX_CHANNELS_PER_LANE; ++k) {
        const int c = li + k * lanes;
        if (c >= hd) break;
        const float ag = a * g[k];
        float gv00 = 0.f, gv01 = 0.f, gv10 = 0.f, gv11 = 0.f;
        if (pt.idx.x >= 0) {
          gv00 = g[k] * to_float(vb[(int64_t)pt.idx.x * C + c]);
          atomicAdd(dvb + (int64_t)pt.idx.x * C + c, ag * w00);
        }
        if (pt.idx.y >= 0) {
          gv01 = g[k] * to_float(vb[(int64_t)pt.idx.y * C + c]);
          atomicAdd(dvb + (int64_t)pt.idx.y * C + c, ag * w01);
        }
        if (pt.idx.z >= 0) {
          gv10 = g[k] * to_float(vb[(int64_t)pt.idx.z * C + c]);
          atomicAdd(dvb + (int64_t)pt.idx.z * C + c, ag * w10);
        }
        if (pt.idx.w >= 0) {
          gv11 = g[k] * to_float(vb[(int64_t)pt.idx.w * C + c]);
          atomicAdd(dvb + (int64_t)pt.idx.w * C + c, ag * w11);
        }
        s_aw += w00 * gv00 + w01 * gv01 + w10 * gv10 + w11 * gv11;
        s_x += (1.f - ly) * (gv01 - gv00) + ly * (gv11 - gv10);
        s_y += (1.f - lx) * (gv10 - gv00) + lx * (gv11 - gv01);
      }
      // the head's lanes are aligned within one warp: xor offsets below
      // `lanes` never leave them
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        s_aw += __shfl_xor_sync(mask, s_aw, off);
        s_x += __shfl_xor_sync(mask, s_x, off);
        s_y += __shfl_xor_sync(mask, s_y, off);
      }
      if (li == 0) {
        const int l = p / P;
        res_loc[row + p] = make_float2((float)lv.w[l] * a * s_x,
                                       (float)lv.h[l] * a * s_y);
        res_aw[row + p] = s_aw;
      }
    }
  }
  __syncthreads();

  // phase 3: this block's d(loc) and d(aw) are contiguous; write coalesced
  float2* dloc2 = reinterpret_cast<float2*>(dloc) + bq0 * nH * LP;
  float* dawq = daw + bq0 * nH * LP;
  for (int i = t; i < n_points; i += blockDim.x) {
    dloc2[i] = res_loc[i];
    dawq[i] = res_aw[i];
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

extern "C" {

// Zeroes dvalue_acc, launches the backward and, for bf16 values, the cast of
// the accumulator into dvalue_out, all on `stream`. Returns the first CUDA
// error (0 = ok). dvalue_acc is fp32 (B, S, nH, hd); dvalue_out is ignored
// for fp32 values. hw holds L (height, width) pairs in the value's order.
int msdeform_attn_bwd(const void* value, int value_is_bf16, const void* loc,
                      const void* aw, const void* grad, void* dvalue_acc,
                      void* dvalue_out, void* dloc, void* daw, int B, int S,
                      int Q, int nH, int hd, int L, int P, const int* hw,
                      int queries_per_block, void* stream) {
  const int point_bytes = nH * L * P * MSDA_BWD_POINT_BYTES;
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || !msda_bwd_takes(nH, hd) ||
      nH * hd > 1024 || point_bytes > MSDA_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (fill_levels(&lv, hw, L) != S) return (int)cudaErrorInvalidValue;
  int qpb = queries_per_block < 1 ? 1 : queries_per_block;
  if (qpb * point_bytes > MSDA_MAX_SMEM) qpb = MSDA_MAX_SMEM / point_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_value = (int64_t)B * S * nH * hd;
  cudaError_t err =
      cudaMemsetAsync(dvalue_acc, 0, (size_t)n_value * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qpb - 1) / qpb, B);
  dim3 block(nH * msda_bwd_lanes(hd));
  const size_t smem = (size_t)qpb * point_bytes;
  float* acc = static_cast<float*>(dvalue_acc);
  if (value_is_bf16) {
    msdeform_attn_bwd_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(aw),
        static_cast<const float*>(grad), acc, static_cast<float*>(dloc),
        static_cast<float*>(daw), Q, S, nH, hd, L, P, qpb, lv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (n_value + 255) / 256;
    f32_to_bf16_kernel<<<(int)(blocks < 65535 ? blocks : 65535), 256, 0,
                         st>>>(acc, static_cast<__nv_bfloat16*>(dvalue_out),
                               n_value);
  } else {
    msdeform_attn_bwd_kernel<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<const float*>(grad), acc,
        static_cast<float*>(dloc), static_cast<float*>(daw), Q, S, nH, hd,
        L, P, qpb, lv);
  }
  return (int)cudaGetLastError();
}

const char* msdeform_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
