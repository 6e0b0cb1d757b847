// Window attention on NHWC maps, backward (Hopper, sm_90a), fp32: the SIMT
// body of K6 (bf16 calls take the tensor-core body of
// window_attn_nhwc_bwd_mma.cu).
//
// Replaces the TPU kernel _wa_nhwc_bwd_impl (body _wa_nhwc_bwd_kernel,
// vision_instance_seg_tpu/kernels/window_attention.py), the recompute
// backward of K5: nothing is saved from the forward but its operands. Per
// (window, head), in fp32 from the operands and the cotangent g:
// s = (q * scale) . k^T + rel where the labels agree, -1e9 where they do
// not (window_attn_common.cuh); p = softmax(s);
// dv = p^T g; dp = g v^T; ds = p (dp - rowsum(dp p)); dq = (ds k) scale;
// dk = (ds^T q) scale. Excluded pairs have p = 0, so ds = 0 exactly and
// their bias cells get no gradient. d(q, k, v) are written in the operands'
// layout and type (fused: one (B, Hp, Wp, 3C) dqkv map). d(rel) (nH, N, N)
// is ds summed over every window of every image.
//
// Bound: memory. At Swin stage 1 in training (qkv (2, 160, 160, 288) fp32)
// it reads 59.0 MB of qkv and 19.7 MB of g and writes 59.0 MB of dqkv:
// 137.6 MB, 41 us at 3.35 TB/s, against ~2.5x the forward's products.
//
// Design, simple first: one block of 256 threads per (group of windows,
// head). For each window of its group the block loads q, k, v and g into
// shared memory as fp32; warps own query rows and recompute s, p, dp and ds
// with the forward's lane layout (lane = keys lane and lane + 32), keeping
// the p and ds tiles in shared memory; then warps own key rows for dv and
// dk and query rows for dq (lanes on channels, the tiles read as
// broadcasts). d(rel) is not summed with atomics: each block adds its
// windows' ds into an N x N shared-memory accumulator (one writer per cell
// and window) and writes it once as its group's partial sum; a second
// kernel sums the groups' partials in a fixed order (window_attn_drel.cuh).
// So d(rel) repeats bit for bit from run to run (for a given shape and
// card, which fix the grouping).

#include "window_attn_common.cuh"
#include "window_attn_drel.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ gout,
                           const float* __restrict__ rel, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ partial, WaGeometry g,
                           int total_windows, int windows_per_block) {
  extern __shared__ float smem[];
  const int N = g.N, hd = g.hd, kst = hd + 1, pst = N + 1;
  float* qs = smem;             // N x hd, unscaled
  float* ks = qs + N * hd;      // N x (hd + 1)
  float* vs = ks + N * kst;     // N x (hd + 1)
  float* gs = vs + N * kst;     // N x hd
  float* P = gs + N * hd;       // N x (N + 1)
  float* dS = P + N * pst;      // N x (N + 1)
  float* acc = dS + N * pst;    // N x N, this block's d(rel) share
  int* lab = reinterpret_cast<int*>(acc + N * N);  // N
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* relh = rel + (int64_t)h * N * N;
  const float scale = g.scale;
  for (int i = tid; i < N * N; i += kThreads) acc[i] = 0.f;

  const int w0 = blockIdx.x * windows_per_block;
  const int w1 = min(w0 + windows_per_block, total_windows);
  for (int w = w0; w < w1; ++w) {
    const int wl = w % g.nW;
    __syncthreads();  // the previous window's tiles are read
    for (int i = tid; i < N * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      qs[i] = wa_load(q + wa_in_offset<LAYOUT>(g, w, h, t, 0) + d);
      ks[t * kst + d] = wa_load(k + wa_in_offset<LAYOUT>(g, w, h, t, 1) + d);
      vs[t * kst + d] = wa_load(v + wa_in_offset<LAYOUT>(g, w, h, t, 2) + d);
      gs[i] = wa_load(gout + wa_out_offset<LAYOUT>(g, w, h, t) + d);
    }
    for (int t = tid; t < N; t += kThreads) lab[t] = wa_label(g, wl, t);
    __syncthreads();

    // query rows: recompute p, then ds
    for (int i = warp; i < N; i += kWarps) {
      float s[2], dp[2];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        s[c] = -INFINITY;
        dp[c] = 0.f;
        if (j < N) {
          float a = 0.f, b = 0.f;
          for (int d = 0; d < hd; ++d) {
            a = fmaf(qs[i * hd + d] * scale, ks[j * kst + d], a);
            b = fmaf(gs[i * hd + d], vs[j * kst + d], b);
          }
          s[c] = a + (lab[i] == lab[j] ? relh[i * N + j] : WA_NEG_INF);
          dp[c] = b;
        }
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      float e[2], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        e[c] = lane + 32 * c < N ? expf(s[c] - mx) : 0.f;
        sum += e[c];
      }
      sum = warp_sum(sum);
      float p[2], rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[c] = e[c] / sum;
        rs += dp[c] * p[c];
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < N) {
          const float ds = p[c] * (dp[c] - rs);
          P[i * pst + j] = p[c];
          dS[i * pst + j] = ds;
          acc[i * N + j] += ds;
        }
      }
    }
    __syncthreads();

    // key rows: dv = p^T g, dk = (ds^T q) scale
    for (int j = warp; j < N; j += kWarps) {
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f, b = 0.f;
        for (int i = 0; i < N; ++i) {
          a = fmaf(P[i * pst + j], gs[i * hd + d], a);
          b = fmaf(dS[i * pst + j], qs[i * hd + d], b);
        }
        wa_store(dv + wa_in_offset<LAYOUT>(g, w, h, j, 2) + d, a);
        wa_store(dk + wa_in_offset<LAYOUT>(g, w, h, j, 1) + d, b * scale);
      }
    }
    // query rows: dq = (ds k) scale
    for (int i = warp; i < N; i += kWarps) {
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f;
        for (int j = 0; j < N; ++j) a = fmaf(dS[i * pst + j], ks[j * kst + d], a);
        wa_store(dq + wa_in_offset<LAYOUT>(g, w, h, i, 0) + d, a * scale);
      }
    }
  }
  __syncthreads();
  float* part = partial + ((int64_t)blockIdx.x * g.nH + h) * N * N;
  for (int i = tid; i < N * N; i += kThreads) part[i] = acc[i];
}

template <typename T, int LAYOUT>
static int launch(const void* q, const void* k, const void* v,
                  const void* gout, const float* rel, void* dq, void* dk,
                  void* dv, float* partial, float* drel, const WaGeometry& g,
                  int total_windows, int wpb, cudaStream_t st) {
  const int N = g.N, hd = g.hd;
  const size_t smem =
      (size_t)(2 * N * hd + 2 * N * (hd + 1) + 2 * N * (N + 1) + N * N) *
          sizeof(float) + N * sizeof(int);
  auto kern = window_attn_bwd_kernel<T, LAYOUT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (total_windows + wpb - 1) / wpb;
  kern<<<dim3(groups, g.nH), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(gout), rel,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), partial,
      g, total_windows, wpb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return wa_drel_sum(partial, drel, groups, g.nH * N * N, st);
}

extern "C" {

// fp32. Fused: q = k = v = the qkv map (B, Hp, Wp, 3C) and dq = dk = dv =
// the dqkv map; split: (B, Hp, Wp, C) each. gout (B, Hp, Wp, C). partial
// holds ceil(B * nW / windows_per_block) x nH x N x N floats; drel
// nH x N x N. Returns cudaGetLastError() (0 = launched).
int window_attn_bwd_nhwc(const void* q, const void* k, const void* v,
                         const void* gout, const void* rel, void* dq,
                         void* dk, void* dv, void* partial, void* drel,
                         int fused, int B, int nH, int C, int Hp, int Wp,
                         int ws, int shift, int pad_h, int pad_w,
                         int windows_per_block, float scale, void* stream) {
  if (ws < 1 || nH < 1 || C % nH || windows_per_block < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  WaGeometry g = {nW, nH, ws * ws, C / nH, C, Hp, Wp, ws, shift,
                  pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* pp = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  const int total = B * nW;
  if (fused)
    return launch<float, WA_NHWC_FUSED>(q, k, v, gout, r, dq, dk, dv, pp, dr,
                                        g, total, windows_per_block, st);
  return launch<float, WA_NHWC_SPLIT>(q, k, v, gout, r, dq, dk, dv, pp, dr, g,
                                      total, windows_per_block, st);
}

const char* window_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
