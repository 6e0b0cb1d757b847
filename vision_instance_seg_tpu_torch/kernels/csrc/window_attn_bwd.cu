// Window attention on NHWC maps, backward (Hopper, sm_90a): the SIMT body of
// K6, for fp32 calls and for bf16 windows past 64 tokens (bf16 windows of
// 64 tokens take the tensor-core body of window_attn_nhwc_bwd_mma.cu).
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
// head), for windows up to 16 x 16 (N <= 256). For each window of its group
// the block stages q, k, v and g in shared memory in the operands' type (N
// x (hd + 1) each, rows padded so that lanes reading different tokens hit
// different banks) and makes two passes, so that no N x N tile is held:
// - query rows (a warp per row i, lanes on keys j = lane, lane + 32, ...):
//   s, p = softmax(s), dp, rs = rowsum(dp p) and ds = p (dp - rs); the row's
//   max, sum and rs are kept (3 N floats), ds goes to a per-warp row buffer
//   and the lanes then take channels for dq_i = scale sum_j ds_ij k_j,
//   written straight out;
// - key rows (a warp per row j, lanes on queries i): p_ij and ds_ij again
//   from the kept row statistics (the same arithmetic, so the same bits),
//   then dv_j = sum_i p_ij g_i and dk_j = scale sum_i ds_ij q_i.
// The second pass recomputes s and dp: 7 N^2 hd products instead of 5,
// against a shared-memory footprint of 4 N (hd + 1) elements plus 19 N
// floats (155 KB at N = 256, hd = 32 in fp32; the wrapper refuses what
// does not fit in 227 KB, fp32 past hd 50 at N = 256). d(rel) is not summed
// with atomics: the warp that owns query row i owns cells (i, j) of the
// block's partial sum in device memory, which it writes for the group's
// first window and adds to for the others; a second kernel sums the
// groups' partials in a fixed order (window_attn_drel.cuh). So d(rel)
// repeats bit for bit from run to run (for a given shape and card, which
// fix the grouping).

#include "window_attn_common.cuh"
#include "window_attn_drel.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = WA_MAX_TOKENS / 32;

// bytes of shared memory for N tokens, head dim hd, operands of `elem` bytes
static inline size_t bwd_smem_bytes(int N, int hd, int elem) {
  return (size_t)4 * N * (hd + 1) * elem +
         (size_t)(3 * N + 2 * kWarps * N) * sizeof(float) + N * sizeof(int);
}

template <typename T, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ gout,
                           const float* __restrict__ rel, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ partial, WaGeometry g,
                           int total_windows, int windows_per_block) {
  extern __shared__ float4 smem_raw[];
  const int N = g.N, hd = g.hd, st = hd + 1;
  T* qs = reinterpret_cast<T*>(smem_raw);  // N x (hd + 1) each, unscaled
  T* ks = qs + N * st;
  T* vs = ks + N * st;
  T* gs = vs + N * st;
  float* rmax = reinterpret_cast<float*>(gs + N * st);  // row statistics
  float* rsum = rmax + N;
  float* rrs = rsum + N;
  float* bufa = rrs + N;              // kWarps x N: p of a key row
  float* bufb = bufa + kWarps * N;    // kWarps x N: ds of a row
  int* lab = reinterpret_cast<int*>(bufb + kWarps * N);  // N
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* relh = rel + (int64_t)h * N * N;
  const float scale = g.scale;
  float* part = partial + ((int64_t)blockIdx.x * g.nH + h) * N * N;
  float* pa = bufa + warp * N;
  float* pb = bufb + warp * N;

  const int w0 = blockIdx.x * windows_per_block;
  const int w1 = min(w0 + windows_per_block, total_windows);
  for (int w = w0; w < w1; ++w) {
    const int wl = w % g.nW;
    __syncthreads();  // the previous window's tiles are read
    for (int i = tid; i < N * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      qs[t * st + d] = q[wa_in_offset<LAYOUT>(g, w, h, t, 0) + d];
      ks[t * st + d] = k[wa_in_offset<LAYOUT>(g, w, h, t, 1) + d];
      vs[t * st + d] = v[wa_in_offset<LAYOUT>(g, w, h, t, 2) + d];
      gs[t * st + d] = gout[wa_out_offset<LAYOUT>(g, w, h, t) + d];
    }
    for (int t = tid; t < N; t += kThreads) lab[t] = wa_label(g, wl, t);
    __syncthreads();

    // query rows: p, rs and ds; d(rel) and dq
    for (int i = warp; i < N; i += kWarps) {
      float s[kRowsPerLane], dp[kRowsPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kRowsPerLane; ++c) {
        const int j = lane + 32 * c;
        s[c] = -INFINITY;
        dp[c] = 0.f;
        if (j < N) {
          float a = 0.f, b = 0.f;
          for (int d = 0; d < hd; ++d) {
            a = fmaf(wa_load(qs + i * st + d) * scale,
                     wa_load(ks + j * st + d), a);
            b = fmaf(wa_load(gs + i * st + d), wa_load(vs + j * st + d), b);
          }
          s[c] = a + (lab[i] == lab[j] ? relh[i * N + j] : WA_NEG_INF);
          dp[c] = b;
        }
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kRowsPerLane; ++c) {
        s[c] = lane + 32 * c < N ? expf(s[c] - mx) : 0.f;
        sum += s[c];
      }
      sum = warp_sum(sum);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kRowsPerLane; ++c) {
        s[c] = s[c] / sum;
        rs += dp[c] * s[c];
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int c = 0; c < kRowsPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < N) {
          const float ds = s[c] * (dp[c] - rs);
          pb[j] = ds;
          float* cell = part + i * N + j;
          *cell = w == w0 ? ds : *cell + ds;
        }
      }
      if (lane == 0) {
        rmax[i] = mx;
        rsum[i] = sum;
        rrs[i] = rs;
      }
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f;
        for (int j = 0; j < N; ++j)
          a = fmaf(pb[j], wa_load(ks + j * st + d), a);
        wa_store(dq + wa_in_offset<LAYOUT>(g, w, h, i, 0) + d, a * scale);
      }
      __syncwarp();
    }
    __syncthreads();

    // key rows: p and ds of column j from the row statistics; dv and dk
    for (int j = warp; j < N; j += kWarps) {
      for (int i = lane; i < N; i += 32) {
        float a = 0.f, b = 0.f;
        for (int d = 0; d < hd; ++d) {
          a = fmaf(wa_load(qs + i * st + d) * scale,
                   wa_load(ks + j * st + d), a);
          b = fmaf(wa_load(gs + i * st + d), wa_load(vs + j * st + d), b);
        }
        const float sv =
            a + (lab[i] == lab[j] ? relh[i * N + j] : WA_NEG_INF);
        const float p = expf(sv - rmax[i]) / rsum[i];
        pa[i] = p;
        pb[i] = p * (b - rrs[i]);
      }
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f, b = 0.f;
        for (int i = 0; i < N; ++i) {
          a = fmaf(pa[i], wa_load(gs + i * st + d), a);
          b = fmaf(pb[i], wa_load(qs + i * st + d), b);
        }
        wa_store(dv + wa_in_offset<LAYOUT>(g, w, h, j, 2) + d, a);
        wa_store(dk + wa_in_offset<LAYOUT>(g, w, h, j, 1) + d, b * scale);
      }
      __syncwarp();
    }
  }
}

template <typename T, int LAYOUT>
static int launch(const void* q, const void* k, const void* v,
                  const void* gout, const float* rel, void* dq, void* dk,
                  void* dv, float* partial, float* drel, const WaGeometry& g,
                  int total_windows, int wpb, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(g.N, g.hd, sizeof(T));
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
  return wa_drel_sum(partial, drel, groups, g.nH * g.N * g.N, st);
}

template <typename T>
static int launch_layout(int fused, const void* q, const void* k,
                         const void* v, const void* gout, const float* rel,
                         void* dq, void* dk, void* dv, float* partial,
                         float* drel, const WaGeometry& g, int total_windows,
                         int wpb, cudaStream_t st) {
  if (fused)
    return launch<T, WA_NHWC_FUSED>(q, k, v, gout, rel, dq, dk, dv, partial,
                                    drel, g, total_windows, wpb, st);
  return launch<T, WA_NHWC_SPLIT>(q, k, v, gout, rel, dq, dk, dv, partial,
                                  drel, g, total_windows, wpb, st);
}

extern "C" {

// fp32 or bf16. Fused: q = k = v = the qkv map (B, Hp, Wp, 3C) and dq = dk
// = dv = the dqkv map; split: (B, Hp, Wp, C) each. gout (B, Hp, Wp, C) in
// the operands' type. partial holds ceil(B * nW / windows_per_block) x nH x
// N x N floats; drel nH x N x N. Returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a window that does not fit in shared memory.
int window_attn_bwd_nhwc(const void* q, const void* k, const void* v,
                         const void* gout, const void* rel, void* dq,
                         void* dk, void* dv, void* partial, void* drel,
                         int is_bf16, int fused, int B, int nH, int C, int Hp,
                         int Wp, int ws, int shift, int pad_h, int pad_w,
                         int windows_per_block, float scale, void* stream) {
  if (ws < 1 || nH < 1 || C % nH || windows_per_block < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  WaGeometry g = {nW, nH, ws * ws, C / nH, C, Hp, Wp, ws, shift,
                  pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  if (bwd_smem_bytes(g.N, g.hd, is_bf16 ? 2 : 4) > WA_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* pp = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  const int total = B * nW;
  if (is_bf16)
    return launch_layout<__nv_bfloat16>(fused, q, k, v, gout, r, dq, dk, dv,
                                        pp, dr, g, total, windows_per_block,
                                        st);
  return launch_layout<float>(fused, q, k, v, gout, r, dq, dk, dv, pp, dr, g,
                              total, windows_per_block, st);
}

const char* window_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
