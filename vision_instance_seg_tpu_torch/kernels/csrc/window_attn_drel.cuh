// The last step of the window-attention backward kernels (the SIMT body of
// window_attn_bwd.cu and the tensor-core bodies of
// window_attn_nhwc_bwd_mma.cu and window_attn_mma256_bwd.cu): d(rel)
// without atomics. Each block or CTA
// writes its run of windows' d(rel) sum as one partial (nH x N x N floats
// per group of blocks); drel[c] = sum over groups of partial[group][c] in
// a fixed order, so d(rel) repeats bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kDrelSlices = 8;  // slices of the groups summed in parallel

// Block (32, kDrelSlices): threadIdx.x one of 32 consecutive cells,
// threadIdx.y a fixed slice of the groups, summed in order; the slices'
// sums are then added in order. The order of every addition is fixed by
// (groups, cells) alone.
static __global__ void wa_drel_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ drel,
                                          int groups, int cells) {
  __shared__ float slice[kDrelSlices][32];
  const int c = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  const int per = (groups + kDrelSlices - 1) / kDrelSlices;
  const int g1 = min(groups, (y + 1) * per);
  float a = 0.f;
  if (c < cells)
    for (int gi = y * per; gi < g1; ++gi)
      a += partial[(int64_t)gi * cells + c];
  slice[y][threadIdx.x] = a;
  __syncthreads();
  if (y == 0 && c < cells) {
#pragma unroll
    for (int k = 1; k < kDrelSlices; ++k) a += slice[k][threadIdx.x];
    drel[c] = a;
  }
}

// Launches wa_drel_sum_kernel; returns cudaGetLastError().
static inline int wa_drel_sum(const float* partial, float* drel, int groups,
                              int cells, cudaStream_t st) {
  wa_drel_sum_kernel<<<(cells + 31) / 32, dim3(32, kDrelSlices), 0, st>>>(
      partial, drel, groups, cells);
  return (int)cudaGetLastError();
}
