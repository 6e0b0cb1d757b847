// Building blocks of the tensor-core window-attention kernels (Hopper,
// sm_90a): the forward K5 (window_attn_nhwc_mma.cu) and its backward K6
// (window_attn_nhwc_bwd_mma.cu). PTX wrappers for 16-byte cp.async,
// ldmatrix, stmatrix and mma.sync m16n8k16 (bf16 in, fp32 accumulate), the quad
// reductions over one mma fragment row, and the NHWC layout policy.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attn_common.cuh"

// NHWC maps: token t of a window sits at pixel (b, wi * 8 + t / 8,
// wj * 8 + t % 8); its head-h slice at channel h * hd of a row of
// `in_stride` (operands) or `out_stride` (output) elements.
struct NhwcLayout {
  int64_t in_stride;
  int64_t out_stride;

  // the window's top-left pixel
  __device__ __forceinline__ int64_t origin(const WaGeometry& g,
                                            int w) const {
    const int b = w / g.nW, wl = w - b * g.nW;
    const int ww = g.Wp >> 3;
    const int wi = wl / ww, wj = wl - wi * ww;
    return ((int64_t)b * g.Hp + wi * 8) * g.Wp + wj * 8;
  }
  __device__ __forceinline__ int64_t pixel(const WaGeometry& g, int64_t o,
                                           int t) const {
    return o + (int64_t)(t >> 3) * g.Wp + (t & 7);
  }
  __device__ __forceinline__ int64_t in(const WaGeometry& g, int64_t o, int h,
                                        int t) const {
    return pixel(g, o, t) * in_stride + h * g.hd;
  }
  __device__ __forceinline__ int64_t out(const WaGeometry& g, int64_t o,
                                         int h, int t) const {
    return pixel(g, o, t) * out_stride + h * g.hd;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ldmatrix reversed: four 8 x 8 bf16 matrices from mma fragments into
// shared memory, lanes 8 m .. 8 m + 7 giving the row addresses of matrix m
__device__ __forceinline__ void stsm_x4(uint32_t addr,
                                        const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :
      : "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// d += a . b for one 16 x 8 tile (k 16): bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> one register of two bf16, lo in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
