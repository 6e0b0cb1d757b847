// Shared geometry of the deformable-sampling kernels (forward and backward).
//
// For one (b, q, head, level, point): x = loc_x * W_l - 0.5 and
// y = loc_y * H_l - 0.5; floor each and clip it to [-2, W_l] / [-2, H_l]
// before the integer cast (the clip carries no gradient, as in the JAX
// package's _corner_geometry); the four bilinear corners are token indices
// into `value`, -1 for a corner outside the map, which contributes exactly
// zero to the output and receives no gradient.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// Corner indices (idx.x = (y0, x0), .y = (y0, x0 + 1), .z = (y0 + 1, x0),
// .w = (y0 + 1, x0 + 1)) and the fractional offsets lx, ly of one sample.
__device__ __forceinline__ int4 corner_geometry(float lx_, float ly_,
                                                const Levels& lv, int l,
                                                float* lx, float* ly) {
  const int H = lv.h[l];
  const int W = lv.w[l];
  // no FMA contraction: round like the plain version (mul, then sub)
  const float x = __fsub_rn(__fmul_rn(lx_, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly_, (float)H), 0.5f);
  const float xf = fminf(fmaxf(floorf(x), -2.f), (float)W);
  const float yf = fminf(fmaxf(floorf(y), -2.f), (float)H);
  *lx = x - xf;
  *ly = y - yf;
  const int x0 = (int)xf;
  const int y0 = (int)yf;
  const bool vx0 = x0 >= 0 && x0 < W;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool vy0 = y0 >= 0 && y0 < H;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const int base = lv.start[l] + y0 * W + x0;
  int4 idx;
  idx.x = vy0 && vx0 ? base : -1;
  idx.y = vy0 && vx1 ? base + 1 : -1;
  idx.z = vy1 && vx0 ? base + W : -1;
  idx.w = vy1 && vx1 ? base + W + 1 : -1;
  return idx;
}

// Fills `lv` from L (height, width) pairs; returns the total token count.
static inline int fill_levels(Levels* lv, const int* hw, int L) {
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start;
}
