// Window attention forward over windows of 16 x 16 (N = 256 tokens) and
// 12 x 12 (N = 144) on the tensor cores (Hopper, sm_90a), bf16 only: the
// 144- and 256-token calls of
// vision_instance_seg_tpu/kernels/window_attention.py
//   K4a _fused_window_attention_impl (:162)  token-major, additive (nW, N, N)
//                                            mask (the window-16 encoder
//                                            under USE_PALLAS_WINDOW_ATTN;
//                                            windows of 16 or 12);
//   K4b _fused_wa_geo_impl (:220)            token-major, region labels of
//                                            (Hp, Wp, ws, shift), ws 16 or
//                                            12 (Swin window 12: Swin-B/L's);
//   K5  _wa_nhwc_impl (:531)                 NHWC maps, fused or split, with
//                                            region and pad labels (the
//                                            window-16 encoder under
//                                            WINDOW_ATTN_NHWC), ws 16 only.
// Per (window, head): out = softmax(q . k^T * scale + rel[h] + mask) . v,
// head dim HD a multiple of 16 up to 64. fp32 calls and other head dims
// take the SIMT body of window_attn_fwd.cu; windows of up to 64 tokens the
// 64-token bodies (window_attn_tokens_mma.cu, window_attn_nhwc_mma.cu)
// (kernels/window_attention.py `tokens_fwd_body`, `nhwc_fwd_body`).
//
// Windows of 12 x 12 are padded to kPad = 192 tokens in shared memory only,
// as the TPU kernel pads N to a multiple of 64: 3 query blocks and 3 key
// blocks. Rows at token >= N are zero-filled by the copies (their source
// address clamped to the block's first row, so that nothing past the
// window, or past the tensor, is read); the bias slice holds -inf in
// columns >= N and 0 in rows >= N, so that padded keys get p = 0 and
// padded query rows stay finite; their labels are -1, which no token
// takes; their rows are not stored. Warps 1-3 of the last query block
// hold only padding at N = 144 and run their products all the same:
// skipping them measured no faster (scripts/bench_mma256_variants.py at
// Swin stage 1, H100 80GB HBM3, 700 W), since the copies set the pace.
// Every padding branch is `if constexpr (kN != kPad)`: the 256-token
// instantiations are unchanged.
//
// Bound. K5 split at the window-16 encoder's finest level in serving
// ((8, 112, 112, 256) x 3, 8 heads x 32): q, k, v 154.1 MB, out 51.4 MB,
// rel (8, 256, 256) fp32 2.1 MB: 207.6 MB, 62.0 us at 3.35 TB/s, against
// 26.3 GFLOP, 26.6 us on the tensor cores. K4a at the same level
// ((392, 8, 256, 32)) reads its (49, 256, 256) fp32 mask too (12.8 MB):
// 220.4 MB, 65.8 us. The softmax takes N^2 = 65,536 ex2 per window-head,
// 205.5 M for these 3,136 window-heads (plus N per key block for the
// rescale, 3.2 M): at 16 per clock per SM (132 SMs, ~1.98 GHz, ~4.2e12/s)
// ~49 us, under the byte bound; a second softmax pass would double it to
// ~98 us, past it. So the softmax is FlashAttention-2's online form, one
// pass of ex2 over each logit. At hd 64 (8 heads, C = 512) the bytes and
// the products double and the ex2 stay, so the byte bound rules further.
//
// Design. The 64-token bodies keep the head's 64 x 64 bias in registers;
// at 256 tokens rel[h] is 256 KB, read per window-head from L2 that would
// be 822 MB per call, 4x the call's DRAM bytes. So:
// - one CTA of 4 warps per (query block of 64 rows, head, run of windows);
//   its 64 x 256 slice of the bias sits in shared memory (rows of 264
//   floats, so that the float2 reads at the S fragment's positions hit 32
//   banks) for the whole run: read once per CTA; 2 CTAs per SM;
// - K4a's mask is shared by the images' windows at the same place, not by
//   a run of neighbouring windows: its runs are windows wl, wl + nW, wl +
//   2 nW, ... (one window place across the batch), and the CTA folds
//   rel[h] + mask[wl] into its bias slice once. No mask is staged per
//   window (the 64-token K4a's 16 KB per window-head copy);
// - the four query-block CTAs of one (window run, head) sit next to each
//   other, then the heads (the NHWC pixel rows of one window), so that
//   each window's K and V come from DRAM once and from L2 the other three
//   times;
// - a step is (window, key block of 64): S = bias + Q K^T over the block
//   on mma.sync m16n8k16 (the warp's 16 query rows as A fragments, loaded
//   once per window; the accumulators start at the bias, kept in units of
//   the raw q . k sum, or at -inf where the labels differ), the online
//   softmax of window_attn_mma.cuh (fp32 running max and sum, O rescaled
//   by exp2(m_old - m_new); one fma and one ex2 a logit), P unnormalized
//   in bf16 as the A fragment of O += P V; O *= 1 / l after the fourth
//   block;
// - 16-byte cp.async of Q (a window's first step), K and V blocks into a
//   ring of stages (3 at HD <= 32, 2 above), one barrier per step;
// - the copies set the pace: with every product switched off, the loop of
//   copies and barriers alone takes 0.16 ms of the 0.29 at K5's shape
//   above (H100 80GB HBM3, 700 W); its four query-block CTAs read each K
//   and V block from L2 (411 MB at hd 32 here). Measured there and no
//   faster: CTAs of 8 warps over 128 query rows (K and V read twice, but 1 CTA per SM;
//   also with 4 copy stages), an L2 prefetch of the next window (slower),
//   the bias slice by cp.async, the next block's Q K^T issued beside this
//   block's softmax;
// - labels (K4b, K5) per window in shared memory, double-buffered, compared
//   only in windows that hold more than one.
// Shared memory per CTA: bias 67,584 B, labels 512 B, a stage 3 x 64 rows
// of HD * 2 + 16 bytes: HD 16 95,744 B, 32 114,176 B (2 CTAs per SM), 48
// 111,104 B (2), 64 123,392 B (1 CTA per SM). At 12 x 12 the bias rows are
// kPad + 8 = 200 floats (51,200 B; 200, like 264, is 8 mod 32, so the
// float2 reads stay conflict-free) and the labels 384 B: HD 32 97,664 B (2
// CTAs per SM).
//
// Numerics against the plain version: the logit is (q . k + bias / scale)
// * scale (the plain version: q * scale . k + bias), the fp32 sum taken in
// the tensor cores' order; K4a's rel + mask is summed in fp32 first, as
// the plain version does; p = exp2(s - running max) (ex2.approx) rounded
// to bf16 before P V, the row sum taken from fp32 p, so the output is the
// plain one with p rounded before and not after the normalization; out
// rounded once from fp32. The 64-token bodies' tolerance holds it
// (tests/test_torch_port_kernels.py
// `test_mma256_bf16_bound_holds_the_body_rounding`).

#include <stdint.h>

#include "window_attn_common.cuh"
#include "window_attn_mma.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps x 16 query rows
constexpr int kBlock = 64;             // query rows per CTA; keys per step
constexpr float kLog2e = 1.4426950408889634f;

enum Mask256 { MASK_TENSOR = 0, MASK_LABELS = 1 };

// windows of WS x WS (16 or 12), padded to kPad tokens in shared memory
template <int WS>
struct Win {
  static_assert(WS == 16 || WS == 12, "windows of 16 x 16 or 12 x 12");
  static constexpr int kN = WS * WS;                       // tokens
  static constexpr int kPad = (kN + kBlock - 1) / kBlock * kBlock;
  static constexpr int kBlocks = kPad / kBlock;  // query blocks, key blocks
  static constexpr int kBiasPitch = kPad + 8;    // floats per bias row
};

template <int WS, int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;               // 16-byte pieces per row
  static constexpr int kPitch = HD * 2 + 16;           // staged row, bytes
  static constexpr int kTileBytes = kBlock * kPitch;   // 64 rows
  static constexpr int kStageBytes = 3 * kTileBytes;   // Q, K block, V block
  static constexpr int kStages = HD <= 32 ? 3 : 2;
  static constexpr int kBiasBytes = kBlock * Win<WS>::kBiasPitch * 4;
  static constexpr int kSmem =
      kBiasBytes + kStages * kStageBytes + 2 * Win<WS>::kPad;
};

// Grid: kBlocks * nH * runs * ceil(total_windows / runs / windows_per_cta)
// CTAs (kBlocks = 4 at 16 x 16, 3 at 12 x 12). CTA x takes query block
// x % kBlocks, head (x / kBlocks) % nH and, with grp = x / (kBlocks nH),
// the windows (first + i) * runs + grp % runs for i < windows_per_cta,
// first = (grp / runs) * windows_per_cta, cut at total_windows / runs.
// runs = nW for K4a (one window place across the images), 1 otherwise
// (consecutive windows). kernels/window_attention.py `mma256_cta_work`
// repeats this for the CPU tests.
template <int WS, int HD, class Layout, int MASK>
__global__ void __launch_bounds__(kThreads, 2)
    wa_mma256_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ rel,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, WaGeometry g, Layout lay,
                     int total_windows, int runs, int windows_per_cta) {
  using W = Win<WS>;
  using T = Tile<WS, HD>;
  constexpr int kN = W::kN, kBlocks = W::kBlocks;
  constexpr bool kPadded = W::kN != W::kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  unsigned char* stages = smem + T::kBiasBytes;
  signed char* labs =
      reinterpret_cast<signed char*>(stages + T::kStages * T::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qb = blockIdx.x % kBlocks;
  const int h = (blockIdx.x / kBlocks) % g.nH;
  const int grp = (blockIdx.x / kBlocks) / g.nH;
  const int place = grp % runs;
  const int first = (grp / runs) * windows_per_cta;
  const int nwin = min(windows_per_cta, total_windows / runs - first);
  const int nsteps = nwin * kBlocks;
  const int q0 = qb * kBlock;  // the CTA's first query token
  // the thread's S fragment: rows r0, r1 = r0 + 8 of the query block;
  // columns 8 j + cb, + 1 of the key block
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, cb = (lane & 3) * 2;
  auto window = [&](int i) { return (first + i) * runs + place; };

  // The copies: the thread's 16-byte pieces of a 64-row block are pieces
  // c = tid + 128 it, at row c / (HD / 8), piece c % (HD / 8); token
  // t0 + t of a block starting at token t0 (a multiple of 16) sits
  // lay.in(g, 0, 0, t) elements past token t0 in both layouts.
  int64_t goff[HD / 16];
  int soff[HD / 16], trow[HD / 16];
#pragma unroll
  for (int it = 0; it < HD / 16; ++it) {
    const int c = tid + it * kThreads;
    const int t = c / T::kChunks, ch = c % T::kChunks;
    goff[it] = lay.in(g, 0, 0, t) + ch * 8;
    soff[it] = t * T::kPitch + ch * 16;
    trow[it] = t;
  }
  // step s = (window s / kBlocks, key block s % kBlocks) into stage
  // s % kStages: the key block's K and V rows and, in a window's first
  // step, its Q rows; rows at token >= kN are zeros, copied from nowhere
  // (the source clamped to the block's first row, a real one: past the
  // window's last row lie the next head's rows, or the tensor's end)
  int64_t load_org = 0;
  auto load = [&](int s) {
    const int kb = s % kBlocks;
    if (kb == 0) load_org = lay.origin(g, window(s / kBlocks));
    const uint32_t st =
        smem_addr(stages + (s % T::kStages) * T::kStageBytes);
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      if (part == 0 && kb != 0) continue;
      const int t0 = part == 0 ? q0 : kb * kBlock;
      const __nv_bfloat16* src =
          (part == 0 ? q : part == 1 ? k : v) + lay.in(g, load_org, h, t0);
#pragma unroll
      for (int it = 0; it < HD / 16; ++it) {
        const uint32_t dst = st + part * T::kTileBytes + soff[it];
        if constexpr (kPadded) {
          const bool real = t0 + trow[it] < kN;
          cp_async16_zfill(dst, real ? src + goff[it] : src, real ? 16 : 0);
        } else {
          cp_async16(dst, src + goff[it]);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  // the bias slice, rows q0 .. q0 + 63, in units of the raw q . k sum:
  // (rel[h] (+ mask[place])) / scale; the logit in base 2 is
  // (q . k + bias) * sl. rel and the mask have rows of kN floats; padded
  // columns get -inf (p = 0), padded rows 0 (finite, never stored).
  {
    const float* rh = rel + ((int64_t)h * kN + q0) * kN;
    const float* mw = MASK == MASK_TENSOR
                          ? mask + ((int64_t)place * kN + q0) * kN
                          : nullptr;
    const float inv = 1.f / g.scale;
#pragma unroll 16
    for (int c = tid; c < kBlock * W::kPad / 2; c += kThreads) {
      const int r = c / (W::kPad / 2), c2 = (c - r * (W::kPad / 2)) * 2;
      float2 b;
      if (!kPadded || (q0 + r < kN && c2 < kN)) {
        b = *reinterpret_cast<const float2*>(rh + r * kN + c2);
        if (MASK == MASK_TENSOR) {
          const float2 m = *reinterpret_cast<const float2*>(mw + r * kN + c2);
          b.x += m.x;
          b.y += m.y;
        }
        b = make_float2(b.x * inv, b.y * inv);
      } else {
        b.x = b.y = q0 + r < kN ? -INFINITY : 0.f;
      }
      *reinterpret_cast<float2*>(bias + r * W::kBiasPitch + c2) = b;
    }
  }

  const float sl = g.scale * kLog2e;
  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int uniform = 1, la = 0, lb = 0;
  for (int s = 0; s < nsteps; ++s) {
    const int i = s / kBlocks, kb = s % kBlocks;
    signed char* lw = labs + (i & 1) * W::kPad;
    int same = 1;
    if (MASK == MASK_LABELS && kb == 0) {
      // window i's labels (window i - 1's, in the other half, may still be
      // read by a warp that is one step behind); -1 at padded tokens, and
      // `same` over the real ones
      const int wl = window(i) % g.nW, ww = g.Wp / WS;
      const int y0 = (wl / ww) * WS, x0 = (wl % ww) * WS;
      const int lab0 = wa_label_at(g, y0, x0);
#pragma unroll
      for (int t = tid; t < W::kPad; t += kThreads) {
        int lab = -1;
        if (!kPadded || t < kN) {
          lab = wa_label_at(g, y0 + t / WS, x0 + t % WS);
          same &= lab == lab0;
        }
        lw[t] = static_cast<signed char>(lab);
      }
    }
    cp_async_wait<T::kStages - 2>();  // step s has landed (this thread's)
    // ... everyone's, and every warp is past step s - 1, whose stage the
    // next load reuses
    const int all = __syncthreads_and(same);
    if (s + T::kStages - 1 < nsteps) load(s + T::kStages - 1);
    cp_async_commit();  // possibly empty: keeps the wait count exact

    const uint32_t qs =
        smem_addr(stages + (s % T::kStages) * T::kStageBytes);
    const uint32_t ks = qs + T::kTileBytes, vs = ks + T::kTileBytes;
    if (kb == 0) {
      wa_load_q<HD>(qa, qs, T::kPitch, warp, lane);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      uniform = all;
      if (MASK == MASK_LABELS && !uniform) {
        la = lw[q0 + r0];
        lb = lw[q0 + r1];
      }
    }

    // S = bias + Q K^T (this warp's 16 rows x the block's 64 keys): the
    // accumulators start at the bias where the labels agree and at -inf
    // (p = 0) where they differ; the diagonal always agrees
    float sc[8][4];
    const float* b0 = bias + r0 * W::kBiasPitch + kb * kBlock + cb;
    const float* b1 = bias + r1 * W::kBiasPitch + kb * kBlock + cb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(b0 + 8 * j);
      const float2 b = *reinterpret_cast<const float2*>(b1 + 8 * j);
      sc[j][0] = a.x;
      sc[j][1] = a.y;
      sc[j][2] = b.x;
      sc[j][3] = b.y;
    }
    if (MASK == MASK_LABELS && !uniform) {
      const signed char* lk = lw + kb * kBlock + cb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = lk[8 * j], c1 = lk[8 * j + 1];
        if (c0 != la) sc[j][0] = -INFINITY;
        if (c1 != la) sc[j][1] = -INFINITY;
        if (c0 != lb) sc[j][2] = -INFINITY;
        if (c1 != lb) sc[j][3] = -INFINITY;
      }
    }
    wa_qk_block<HD>(sc, qa, ks, T::kPitch, lane);
    wa_online_softmax<HD>(sc, o, sl, m0, m1, l0, l1);
    // O += P V, P unnormalized in bf16
    wa_pv_block<HD>(o, sc, 1.f, 1.f, vs, T::kPitch, lane);

    if (kb == kBlocks - 1) {
      // rows q0 + r0 and q0 + r1 of the output head slice, as bf16 pairs
      // (the real rows only)
      const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
      const int64_t org = lay.origin(g, window(i));
      __nv_bfloat16* d0 = out + lay.out(g, org, h, q0 + r0) + cb;
      __nv_bfloat16* d1 = out + lay.out(g, org, h, q0 + r1) + cb;
      const bool w0 = !kPadded || q0 + r0 < kN;
      const bool w1 = !kPadded || q0 + r1 < kN;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        if (w0)
          *reinterpret_cast<uint32_t*>(d0 + dn * 8) =
              pack_bf16(o[dn][0] * i0, o[dn][1] * i0);
        if (w1)
          *reinterpret_cast<uint32_t*>(d1 + dn * 8) =
              pack_bf16(o[dn][2] * i1, o[dn][3] * i1);
      }
    }
  }
}

template <int WS, int HD, class Layout, int MASK>
int launch_hd(const void* q, const void* k, const void* v, const float* rel,
              const float* mask, void* out, const WaGeometry& g,
              const Layout& lay, int total_windows, int runs,
              int windows_per_cta, cudaStream_t stream) {
  auto kern = wa_mma256_kernel<WS, HD, Layout, MASK>;
  const int smem = Tile<WS, HD>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int per_run = total_windows / runs;
  const int groups = runs * ((per_run + windows_per_cta - 1) / windows_per_cta);
  kern<<<groups * g.nH * Win<WS>::kBlocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel, mask,
      static_cast<__nv_bfloat16*>(out), g, lay, total_windows, runs,
      windows_per_cta);
  return (int)cudaGetLastError();
}

template <int WS, class Layout, int MASK>
int launch(const void* q, const void* k, const void* v, const void* rel,
           const void* mask, void* out, const WaGeometry& g, const Layout& lay,
           int total_windows, int runs, int windows_per_cta, void* stream) {
  if (g.N != Win<WS>::kN || g.nH < 1 || g.nW < 1 || total_windows < 1 ||
      total_windows % g.nW || windows_per_cta < 1 || runs < 1 ||
      total_windows % runs)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15 ||
      ((uintptr_t)rel | (uintptr_t)mask | (uintptr_t)out) & 7)
    return (int)cudaErrorMisalignedAddress;
  const float* r = static_cast<const float*>(rel);
  const float* m = static_cast<const float*>(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g.hd) {
    case 16:
      return launch_hd<WS, 16, Layout, MASK>(q, k, v, r, m, out, g, lay,
                                             total_windows, runs,
                                             windows_per_cta, st);
    case 32:
      return launch_hd<WS, 32, Layout, MASK>(q, k, v, r, m, out, g, lay,
                                             total_windows, runs,
                                             windows_per_cta, st);
    case 48:
      return launch_hd<WS, 48, Layout, MASK>(q, k, v, r, m, out, g, lay,
                                             total_windows, runs,
                                             windows_per_cta, st);
    case 64:
      return launch_hd<WS, 64, Layout, MASK>(q, k, v, r, m, out, g, lay,
                                             total_windows, runs,
                                             windows_per_cta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4a in bf16 at 256 or 144 tokens: q/k/v/out (total_windows, nH, N, hd);
// mask (nW, N, N) fp32 added to window w's logits at w % nW; rel (nH, N,
// N) fp32. hd 16, 32, 48 or 64; q, k, v 16-byte, rel, mask and out 8-byte
// aligned. The arguments are those of window_attn_tokens_mma_mask (N must
// be 256 or 144: windows of 16 x 16 or 12 x 12); windows_per_cta from the
// wrapper's plan (at most total_windows / nW). Returns cudaGetLastError()
// (0 = launched).
int window_attn_tokens_mma256_mask(const void* q, const void* k,
                                   const void* v, const void* rel,
                                   const void* mask, void* out,
                                   int total_windows, int nW, int nH, int N,
                                   int hd, int windows_per_cta, float scale,
                                   void* stream) {
  const WaGeometry g = {nW, nH, N, hd, nH * hd, 0, 0, 1, 0, 0, 0, scale};
  if (N == Win<16>::kN)
    return launch<16, TokensLayout, MASK_TENSOR>(
        q, k, v, rel, mask, out, g, TokensLayout{}, total_windows, nW,
        windows_per_cta, stream);
  if (N == Win<12>::kN)
    return launch<12, TokensLayout, MASK_TENSOR>(
        q, k, v, rel, mask, out, g, TokensLayout{}, total_windows, nW,
        windows_per_cta, stream);
  return (int)cudaErrorInvalidValue;
}

// K4b in bf16 at 256 or 144 tokens: as K4a with the region labels of the
// (Hp, Wp, ws, shift) geometry instead of a mask tensor (the arguments of
// window_attn_tokens_mma_geo; ws must be 16 or 12).
int window_attn_tokens_mma256_geo(const void* q, const void* k, const void* v,
                                  const void* rel, void* out,
                                  int total_windows, int nH, int hd, int Hp,
                                  int Wp, int ws, int shift,
                                  int windows_per_cta, float scale,
                                  void* stream) {
  if ((ws != 16 && ws != 12) || Hp % ws || Wp % ws || shift < 0 ||
      shift >= ws)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws);
  const WaGeometry g = {nW, nH, ws * ws, hd, nH * hd, Hp, Wp, ws, shift,
                        0, 0, scale};
  if (ws == 16)
    return launch<16, TokensLayout, MASK_LABELS>(
        q, k, v, rel, nullptr, out, g, TokensLayout{}, total_windows, 1,
        windows_per_cta, stream);
  return launch<12, TokensLayout, MASK_LABELS>(
      q, k, v, rel, nullptr, out, g, TokensLayout{}, total_windows, 1,
      windows_per_cta, stream);
}

// K5 in bf16 at windows of 16 x 16: fused (q = the (B, Hp, Wp, 3C) qkv map;
// k and v ignored) or split q, k, v maps (B, Hp, Wp, C); rel (nH, 256, 256)
// fp32; out (B, Hp, Wp, C); pad_h = pad_w = 0: no pad labels. The
// arguments of window_attn_nhwc_mma (which takes windows of 8).
int window_attn_nhwc_mma256(const void* q, const void* k, const void* v,
                            const void* rel, void* out, int fused, int B,
                            int nH, int C, int Hp, int Wp, int shift,
                            int pad_h, int pad_w, int windows_per_cta,
                            float scale, void* stream) {
  constexpr int kWs = 16;
  if (B < 1 || nH < 1 || C % nH || shift < 0 || shift >= kWs || Hp < kWs ||
      Wp < kWs)
    return (int)cudaErrorInvalidValue;
  const int nW = (Hp / kWs) * (Wp / kWs);
  const WaGeometry g = {nW, nH, Win<kWs>::kN, C / nH, C, Hp, Wp, kWs, shift,
                        pad_h, pad_w, scale};
  if (const int e = wa_check(g, WA_NHWC_SPLIT)) return e;
  const char* qb = static_cast<const char*>(q);
  const void* kp = fused ? qb + (size_t)C * 2 : k;
  const void* vp = fused ? qb + (size_t)C * 4 : v;
  const NhwcWindowLayout<kWs> lay = {fused ? 3 * (int64_t)C : (int64_t)C,
                                     (int64_t)C};
  return launch<kWs, NhwcWindowLayout<kWs>, MASK_LABELS>(
      q, kp, vp, rel, nullptr, out, g, lay, B * nW, 1, windows_per_cta,
      stream);
}

const char* window_attn_mma256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

namespace {

template <int WS, class Layout, int MASK>
int occupancy() {
  auto kern = wa_mma256_kernel<WS, 32, Layout, MASK>;
  const int smem = Tile<WS, 32>::kSmem;
  int n = -1;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem);
  return n;
}

}  // namespace

// CTAs per SM of three instantiations at head dim 32 (-1 if the query
// fails): 0 = K4a at 16 x 16, 1 = K5 at 16 x 16, 2 = K4b at 12 x 12
extern "C" int window_attn_mma256_occupancy(int which) {
  if (which == 0) return occupancy<16, TokensLayout, MASK_TENSOR>();
  if (which == 1) return occupancy<16, NhwcWindowLayout<16>, MASK_LABELS>();
  if (which == 2) return occupancy<12, TokensLayout, MASK_LABELS>();
  return -1;
}
