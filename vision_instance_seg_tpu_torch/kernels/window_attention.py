"""Window attention (Swin blocks, window encoder): CUDA kernels and plain
versions.

Port of ``vision_instance_seg_tpu/kernels/window_attention.py``. The CUDA
kernels under ``csrc/`` replace its four TPU kernels (K4a, K4b, K5 and
K5's backward K6):

- K4a ``_fused_window_attention_impl``: token-major q/k/v (nWt, nH, N, hd)
  with an additive (nW, N, N) mask tensor (-100 / 0);
- K4b ``_fused_wa_geo_impl``: the same operands, the shifted-window region
  mask computed from the geometry (Hp, Wp, ws, shift), excluded pairs at
  -1e9;
- K5 ``_wa_nhwc_impl``: window partition + attention + merge in one pass on
  NHWC maps, from a fused (B, Hp, Wp, 3C) qkv map (Swin blocks) or split
  (B, Hp, Wp, C) q, k, v maps (window encoder, with canvas-pad labels).

Each kernel has a SIMT body and tensor-core bodies, and which one runs is
a rule on dtype and shape, chosen before the launch; it is not a fallback:

- K4a and K4b (``tokens_fwd_body``): bf16 windows of up to 64 tokens with a
  head dim that is a multiple of 16 run ``csrc/window_attn_tokens_mma.cu``
  (the 64-token tensor-core body, windows padded to 64 tokens in shared
  memory), bf16 windows of 256 tokens (16 x 16) and of 144 tokens (12 x
  12, Swin-B/L's window, padded to 192 in shared memory) with such a head
  dim ``csrc/window_attn_mma256.cu`` (64-key blocks, online softmax); fp32,
  the other windows past 64 tokens and other head dims run the SIMT body of
  ``csrc/window_attn_fwd.cu``.
- K5 (``nhwc_fwd_body``): bf16 windows of 64 tokens run
  ``csrc/window_attn_nhwc_mma.cu`` (head dim a multiple of 16; anything
  else raises, as does a bf16 window under 64 tokens, which the JAX K5
  never takes), bf16 windows of 256 tokens with such a head dim
  ``csrc/window_attn_mma256.cu``; fp32 and the other bf16 windows of 256
  tokens run the SIMT body of ``window_attn_fwd.cu``.
- K6 ``_wa_nhwc_bwd_impl``, the recompute backward of K5 (d(operands) and
  d(rel) summed over every window), by ``nhwc_bwd_body`` (K5's rule): bf16
  windows of 64 tokens take the tensor-core body of
  ``csrc/window_attn_nhwc_bwd_mma.cu``, bf16 windows of 256 tokens with a
  head dim that is a multiple of 16 the two tensor-core kernels of
  ``csrc/window_attn_mma256_bwd.cu`` (row statistics, dQ and d(rel) by
  query block; dK and dV by key block); P and dS are rounded to bf16
  before the products dV, dQ, dK, as FlashAttention-2 and SDPA do. fp32
  and the other bf16 windows of 256 tokens run the SIMT body of
  ``csrc/window_attn_bwd.cu``. All sum d(rel) in order, without atomics.

The fp32 SIMT bodies are held bit-equal (forward) or within 1e-4 (K6) to
the plain versions. The envelope on the card: K4a and K4b take any window
up to 256 tokens (16 x 16; JAX's K4 takes any), K5 and K6 any ws % 8 == 0
up to 256 tokens (ws 8 and 16), every head dim up to 64; the tensor-core
forwards and K6 take bf16 windows of up to 64 tokens (K5 and K6: exactly
64) and of 256 tokens at head dims 16, 32, 48 and 64, K4 also of 144
tokens at those head dims; the SIMT K6 holds a
window in shared memory and so takes, at 256 tokens, fp32 head dims up to
50 (``simt_bwd_max_head_dim``). Past the envelope the wrappers raise and
name the limit.

Every version computes the logits and the softmax in fp32:
``softmax(q * scale . k^T + rel + mask)``, then casts p to v's dtype and
takes ``p . v`` with fp32 accumulation into the operands' dtype. The masks
are those of the TPU kernels, which are not all the same: K4a adds the mask
tensor; K4b excludes pairs whose region labels (3 ry + rx at rolled
coordinates) differ; K5 and K6 exclude by region label plus 10 x the pad
label, taken at pre-roll coordinates when ``pad_hw`` is given (None: padded
tokens attend like real ones, as in the backbone).

The entry points the model calls have the JAX contracts and attributes:
``window_attention`` (K4a, or K4b when given ``geometry``;
``wants_geometry``), ``window_attention_nhwc`` (K5 fused) and
``window_attention_nhwc_split`` (K5 split; ``wants_nhwc``). A CPU tensor
takes the plain version, a CUDA tensor a kernel, and nothing falls back.
Gradients run through ``WindowAttentionFunction`` (K4 forward, the JAX
package's recompute backward in torch ops, since JAX wrote that backward in
jnp) and ``WindowAttentionNHWCFunction`` (K5 forward, K6 backward on CUDA,
the written-out plain backward on the CPU). ``LAUNCHES`` counts the kernel
launches by name: k4a, k4b, k5_fused, k5_split, k6_fused, k6_split, and the
launches that ran a tensor-core body (of 64, 144 or 256 tokens) once more
under k4a_mma, k4b_mma, k5_fused_mma, k5_split_mma, k6_fused_mma and
k6_split_mma.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e9               # the TPU kernels' excluded-pair logit
MAX_TOKENS = 256             # csrc WA_MAX_TOKENS: windows up to 16 x 16
MAX_HEAD_DIM = 64            # csrc WA_MAX_HEAD_DIM
MAX_SMEM = 232448            # csrc WA_MAX_SMEM: a block's shared memory
MMA_TOKENS = 64              # the tensor-core bodies' (padded) windows
MMA256_TOKENS = 256          # ... and the 16 x 16 windows of the 256-token body
MMA256_QUERY_BLOCKS = 4      # its CTAs: 64 query rows each
MMA144_TOKENS = 144          # K4's 12 x 12 windows on that body (3 blocks)
MMA_MAX_WINDOWS_PER_CTA = 16
MMA_BWD_MIN_WINDOWS_PER_CTA = 3   # K6: d(rel) partials under 1/5 of bytes
LAUNCHES: collections.Counter = collections.Counter()

Geometry = Tuple[int, int, int, int]        # (Hp, Wp, ws, shift)


# ------------------------------------------------------------ plain versions
def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _unpartition(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def window_labels(hp: int, wp: int, ws: int, shift: int,
                  pad_hw: Optional[Tuple[int, int]],
                  device: torch.device) -> torch.Tensor:
    """(nW, N) int labels of every window's tokens: the shifted-window
    region 3 ry + rx at rolled coordinates when shifted, plus 10 x [token
    is canvas padding at pre-roll coordinates] when ``pad_hw`` is given.
    Pairs with equal labels attend."""
    ys = torch.arange(hp, device=device)
    xs = torch.arange(wp, device=device)
    lab = torch.zeros((hp, wp), dtype=torch.int64, device=device)
    if shift > 0:
        ry = (ys >= hp - ws).long() + (ys >= hp - shift).long()
        rx = (xs >= wp - ws).long() + (xs >= wp - shift).long()
        lab = lab + 3 * ry[:, None] + rx[None, :]
    if pad_hw is not None:
        oy = (ys + shift) % hp
        ox = (xs + shift) % wp
        pad = (oy >= pad_hw[0])[:, None] | (ox >= pad_hw[1])[None, :]
        lab = lab + 10 * pad.long()
    return _partition(lab[None, :, :, None], ws)[..., 0]


def window_keep(hp: int, wp: int, ws: int, shift: int,
                pad_hw: Optional[Tuple[int, int]],
                device: torch.device) -> torch.Tensor:
    """(nW, N, N) bool: which (query, key) pairs of each window attend."""
    lab = window_labels(hp, wp, ws, shift, pad_hw, device)
    return lab[:, :, None] == lab[:, None, :]


def window_mask(hp: int, wp: int, ws: int, shift: int,
                pad_hw: Optional[Tuple[int, int]],
                device: torch.device) -> torch.Tensor:
    """(nW, N, N) fp32 additive mask of the same labels, -100 between
    different ones: the JAX ``_shift_attn_mask`` (backbone, pad_hw None)
    and ``_window_pad_shift_mask`` (window encoder, pad_hw = (h, w)).
    -100 rather than -inf keeps all-pad rows finite."""
    keep = window_keep(hp, wp, ws, shift, pad_hw, device)
    return torch.where(keep, 0.0, -100.0)


def _attend(q, k, v, scale: float, bias: torch.Tensor) -> torch.Tensor:
    """(..., N, hd) operands, additive fp32 bias broadcastable to the
    (..., N, N) logits -> fp32 logits and softmax, p in v's dtype, fp32
    accumulation, output in q's dtype."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) + bias
    p = s.softmax(-1).to(v.dtype).float()
    return torch.matmul(p, v.float()).to(q.dtype)


def window_attention_mask_torch(q, k, v, rel_bias, shift_mask, scale: float,
                                num_windows: int) -> torch.Tensor:
    """Plain K4a: q/k/v (nWt, nH, N, hd), rel_bias (nH, N, N), shift_mask
    (num_windows, N, N) added to every image's windows."""
    nwt, nh, n, hd = q.shape
    shp = (nwt // num_windows, num_windows, nh, n, hd)
    with torch.autocast(q.device.type, enabled=False):
        bias = rel_bias.float()[None] + shift_mask.float()[:, None]
        out = _attend(q.reshape(shp), k.reshape(shp), v.reshape(shp),
                      scale, bias)
    return out.reshape(nwt, nh, n, hd)


def window_attention_geo_torch(q, k, v, rel_bias, scale: float,
                               num_windows: int,
                               geometry: Geometry) -> torch.Tensor:
    """Plain K4b: as K4a with pairs of different shifted-window regions
    excluded (logit -1e9) instead of a mask tensor."""
    nwt, nh, n, hd = q.shape
    hp, wp, ws, shift = geometry
    shp = (nwt // num_windows, num_windows, nh, n, hd)
    keep = window_keep(hp, wp, ws, shift, None, q.device)
    with torch.autocast(q.device.type, enabled=False):
        bias = torch.where(keep[:, None], rel_bias.float()[None], NEG_INF)
        out = _attend(q.reshape(shp), k.reshape(shp), v.reshape(shp),
                      scale, bias)
    return out.reshape(nwt, nh, n, hd)


def window_attention_torch(q, k, v, rel_bias, shift_mask, scale: float,
                           num_windows: int,
                           geometry: Optional[Geometry] = None
                           ) -> torch.Tensor:
    """Plain version of ``window_attention`` (same contract): K4b when
    ``geometry`` is given, else K4a (zeros for a missing mask)."""
    if geometry is not None:
        return window_attention_geo_torch(q, k, v, rel_bias, scale,
                                          num_windows, geometry)
    if shift_mask is None:
        shift_mask = q.new_zeros((num_windows,) + q.shape[2:3] * 2,
                                 dtype=torch.float32)
    return window_attention_mask_torch(q, k, v, rel_bias, shift_mask, scale,
                                       num_windows)


def window_attention_bwd_torch(q, k, v, rel_bias, shift_mask, g,
                               scale: float, num_windows: int):
    """The K4 backward, the JAX ``_fused_wa_bwd`` (fp32 recompute with the
    additive mask): returns dq, dk, dv in the operands' dtypes and d(rel)
    in rel's dtype."""
    nwt, nh, n, hd = q.shape
    shp = (nwt // num_windows, num_windows, nh, n, hd)
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, gf = (t.reshape(shp).float() for t in (q, k, v, g))
        s = torch.matmul(qf * scale, kf.transpose(-1, -2))
        s = s + (rel_bias.float()[None] + shift_mask.float()[:, None])
        p = s.softmax(-1)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        drel = ds.sum((0, 1))
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(q.shape).to(k.dtype),
            dv.reshape(q.shape).to(v.dtype), drel.to(rel_bias.dtype))


def _split_qkv(operands):
    if len(operands) == 3:
        return operands
    c = operands[0].shape[-1] // 3
    qkv = operands[0]
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def _nhwc_windows(x: torch.Tensor, ws: int, nh: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * nW, nH, N, hd) fp32."""
    xw = _partition(x.float(), ws)
    return xw.reshape(xw.shape[0], xw.shape[1], nh, -1).transpose(1, 2)


def _nhwc_merge(x: torch.Tensor, ws: int, hp: int, wp: int) -> torch.Tensor:
    """(B * nW, nH, N, hd) -> (B, Hp, Wp, C)."""
    nwt, nh, n, hd = x.shape
    return _unpartition(x.transpose(1, 2).reshape(nwt, n, nh * hd), ws, hp,
                        wp)


def window_attention_nhwc_plain(operands: Sequence[torch.Tensor], rel_bias,
                                scale: float, geometry: Geometry,
                                pad_hw: Optional[Tuple[int, int]] = None
                                ) -> torch.Tensor:
    """Plain K5: operands (qkv,) fused (B, Hp, Wp, 3C) or (q, k, v) split
    (B, Hp, Wp, C) each -> (B, Hp, Wp, C) in the operands' dtype."""
    hp, wp, ws, shift = geometry
    q, k, v = _split_qkv(operands)
    nh = rel_bias.shape[0]
    nw = (hp // ws) * (wp // ws)
    keep = window_keep(hp, wp, ws, shift, pad_hw, q.device)
    with torch.autocast(q.device.type, enabled=False):
        qw, kw, vw = (_nhwc_windows(t, ws, nh) for t in (q, k, v))
        nwt, _, n, hd = qw.shape
        shp = (nwt // nw, nw, nh, n, hd)
        bias = torch.where(keep[:, None], rel_bias.float()[None], NEG_INF)
        out = _attend(qw.reshape(shp), kw.reshape(shp),
                      vw.to(v.dtype).reshape(shp), scale, bias)
        out = _nhwc_merge(out.reshape(nwt, nh, n, hd).float(), ws, hp, wp)
    return out.to(q.dtype)


def window_attention_nhwc_bwd_torch(operands: Sequence[torch.Tensor],
                                    rel_bias, g, scale: float,
                                    geometry: Geometry,
                                    pad_hw: Optional[Tuple[int, int]] = None):
    """Plain K6, written out like ``_wa_nhwc_bwd_kernel``'s arithmetic: the
    attention recomputed in fp32 from the operands, then dv = p^T g,
    dp = g v^T, ds = p (dp - rowsum(dp p)), dq = ds k scale,
    dk = ds^T q scale; excluded pairs have p = 0 and so ds = 0 exactly.
    ``g`` (B, Hp, Wp, C) comes in the operands' dtype. Returns d(operands)
    in the operands' layouts and dtype, then d(rel) (nH, N, N) fp32 summed
    over every window of every image."""
    hp, wp, ws, shift = geometry
    q, k, v = _split_qkv(operands)
    nh = rel_bias.shape[0]
    nw = (hp // ws) * (wp // ws)
    keep = window_keep(hp, wp, ws, shift, pad_hw, q.device)
    with torch.autocast(q.device.type, enabled=False):
        qw, kw, vw, gw = (_nhwc_windows(t, ws, nh) for t in (q, k, v, g))
        nwt, _, n, hd = qw.shape
        shp = (nwt // nw, nw, nh, n, n)
        s = torch.matmul(qw * scale, kw.transpose(-1, -2)).reshape(shp)
        s = s + torch.where(keep[:, None], rel_bias.float()[None], NEG_INF)
        p = s.softmax(-1).reshape(nwt, nh, n, n)
        dv = torch.matmul(p.transpose(-1, -2), gw)
        dp = torch.matmul(gw, vw.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.matmul(ds, kw) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qw) * scale
        drel = ds.sum(0)
        grads = [_nhwc_merge(t, ws, hp, wp).to(q.dtype) for t in (dq, dk, dv)]
    if len(operands) == 1:
        grads = [torch.cat(grads, -1)]
    return (*grads, drel)


def window_attention_nhwc_torch(qkv, rel_bias, scale: float,
                                geometry: Geometry) -> torch.Tensor:
    """Plain version of ``window_attention_nhwc`` (same contract)."""
    return window_attention_nhwc_plain((qkv,), rel_bias, float(scale),
                                       _int_geometry(geometry))


def window_attention_nhwc_split_torch(q, k, v, rel_bias, scale: float,
                                      geometry: Geometry,
                                      pad_hw=None) -> torch.Tensor:
    """Plain version of ``window_attention_nhwc_split`` (same contract)."""
    geometry = _int_geometry(geometry)
    return window_attention_nhwc_plain((q, k, v), rel_bias, float(scale),
                                       geometry, _pad_or_none(pad_hw,
                                                              geometry))


window_attention_torch.wants_geometry = True
window_attention_nhwc_torch.wants_nhwc = True
window_attention_nhwc_split_torch.wants_nhwc = True


def _int_geometry(geometry) -> Geometry:
    hp, wp, ws, shift = (int(x) for x in geometry)
    return hp, wp, ws, shift


def _pad_or_none(pad_hw, geometry: Geometry) -> Optional[Tuple[int, int]]:
    """``pad_hw == (Hp, Wp)`` means no pad tokens: None, as in JAX."""
    if pad_hw is None or tuple(pad_hw) == geometry[:2]:
        return None
    return int(pad_hw[0]), int(pad_hw[1])


# ------------------------------------------------------------- CUDA kernels
def _check_common(tensors, rel_bias, n: int, hd: int) -> None:
    dtype, dev = tensors[0].dtype, tensors[0].device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"operand dtype {dtype}: float32 or bfloat16")
    for t in tensors:
        if t.dtype != dtype or t.device != dev:
            raise ValueError("operands must share one dtype and device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if rel_bias.dtype != torch.float32 or not rel_bias.is_contiguous() \
            or rel_bias.device != dev:
        raise ValueError("rel_bias must be contiguous float32 on the "
                         "operands' device")
    if tuple(rel_bias.shape[1:]) != (n, n):
        raise ValueError(f"rel_bias {tuple(rel_bias.shape)} for {n} tokens")
    if not (1 <= n <= MAX_TOKENS and 1 <= hd <= MAX_HEAD_DIM):
        raise ValueError(f"{n} tokens x head_dim {hd}: the window kernels "
                         f"take windows of up to {MAX_TOKENS} tokens (16 x "
                         f"16) and head dims up to {MAX_HEAD_DIM}")


def _check_tokens(q, k, v, rel_bias, num_windows: int) -> None:
    nwt, nh, n, hd = q.shape
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: want one (nWt, nH, N, hd)")
    if nwt % num_windows or rel_bias.shape[0] != nh:
        raise ValueError(f"{nwt} windows, {num_windows} per image, "
                         f"rel_bias {tuple(rel_bias.shape)}")
    _check_common((q, k, v), rel_bias, n, hd)


def _check_nhwc(operands, rel_bias, geometry: Geometry) -> None:
    hp, wp, ws, shift = geometry
    b, h, w, cx = operands[0].shape
    nh = rel_bias.shape[0]
    c = cx if len(operands) == 3 else cx // 3
    if (h, w) != (hp, wp) or hp % ws or wp % ws or not 0 <= shift < ws:
        raise ValueError(f"maps {tuple(operands[0].shape)} vs geometry "
                         f"{geometry}")
    if ws % 8:
        raise ValueError(f"window {ws}: K5 and K6 take windows of a multiple "
                         "of 8, as the JAX kernels do (sublane tiling)")
    if any(t.shape != operands[0].shape for t in operands) \
            or c % nh or (len(operands) == 1 and cx % 3):
        raise ValueError(f"operands {[tuple(t.shape) for t in operands]} "
                         f"for {nh} heads")
    _check_common(operands, rel_bias, ws * ws, c // nh)


def _check_nhwc_fwd(operands, rel_bias, geometry: Geometry) -> None:
    """K5's checks: K6's, then its body's rule and alignment."""
    _check_nhwc(operands, rel_bias, geometry)
    ws, nh = geometry[2], rel_bias.shape[0]
    c = operands[0].shape[-1] // (1 if len(operands) == 3 else 3)
    if nhwc_fwd_body(operands[0].dtype, c // nh, ws * ws) == "mma" and (
            any(t.data_ptr() % 16 for t in operands)
            or rel_bias.data_ptr() % 8):
        raise ValueError("the tensor-core body copies 16 bytes at a time: "
                         "operands must start 16-byte aligned")


def nhwc_fwd_body(dtype: torch.dtype, hd: int, n: int) -> str:
    """Which K5 body runs for operands of ``dtype`` and windows of ``n``
    tokens: "mma" (bf16 windows of 64 tokens, the tensor-core body of
    ``csrc/window_attn_nhwc_mma.cu``; bf16 windows of 256 tokens at a head
    dim that is a multiple of 16, ``csrc/window_attn_mma256.cu``) or "simt"
    (fp32, the other bf16 windows past 64 tokens: the body of
    ``csrc/window_attn_fwd.cu``). A bf16 window of 64 tokens needs a head
    dim that is a multiple of 16 (the mma tiles' depth), and a bf16 window
    under 64 tokens (not ws % 8 == 0, which the JAX K5 never takes)
    raises."""
    if dtype != torch.bfloat16:
        return "simt"
    if n == MMA256_TOKENS:
        return "mma" if hd % 16 == 0 else "simt"
    if n > MMA_TOKENS:
        return "simt"
    if n != MMA_TOKENS or hd % 16:
        raise ValueError(f"bf16 K5 and K6 run on the tensor cores at 8 x 8 "
                         f"windows, which take a head dim that is a multiple "
                         f"of 16: got {n} tokens, head dim {hd}")
    return "mma"


def tokens_fwd_body(dtype: torch.dtype, hd: int, n: int) -> str:
    """Which K4a / K4b body runs: "mma" (bf16, head dim a multiple of 16:
    windows of up to 64 tokens on the tensor-core body of
    ``csrc/window_attn_tokens_mma.cu``, padded to 64 tokens in shared
    memory; windows of 256 and of 144 tokens on
    ``csrc/window_attn_mma256.cu``, 144 padded to 192) or "simt" (fp32,
    the other windows past 64 tokens or other head dims: the body of
    ``csrc/window_attn_fwd.cu``, which takes them as the JAX K4 does)."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and (
            n <= MMA_TOKENS or n in (MMA144_TOKENS, MMA256_TOKENS)):
        return "mma"
    return "simt"


def mma256_query_blocks(n: int) -> int:
    """Query blocks (and key blocks) of 64 rows of the 256-token body at
    windows of ``n`` tokens: 4 at 256, 3 at 144 (padded to 192)."""
    return -(-n // MMA_TOKENS)


def mma256_plan(total_windows: int, heads: int, sms: int, runs: int = 1,
                n: int = MMA256_TOKENS) -> Tuple[int, int]:
    """(windows per CTA, CTAs) of the 256-token tensor-core body
    (``csrc/window_attn_mma256.cu``) at windows of ``n`` tokens (256 or
    144): one CTA per query block (``mma256_query_blocks``), head and run
    of windows; runs long enough that the grid is about 8 CTAs per SM
    (four waves at the 2 CTAs per SM its shared memory allows), at most 16
    windows, so that each CTA's bias slice (64 KB at 256 tokens, 50 KB at
    144) serves many windows. ``runs`` = nW for K4a, whose runs are one
    window place across the images (they share the mask), so a run is at
    most total / nW long; 1 for K4b and K5 (runs of consecutive
    windows)."""
    blocks = mma256_query_blocks(n)
    per_run = total_windows // runs
    wpc = -(-total_windows * heads * blocks // (8 * sms))
    wpc = max(1, min(MMA_MAX_WINDOWS_PER_CTA, per_run, wpc))
    return wpc, blocks * heads * runs * -(-per_run // wpc)


def mma256_cta_work(cta: int, heads: int, windows_per_cta: int,
                    total_windows: int, runs: int = 1,
                    n: int = MMA256_TOKENS
                    ) -> Tuple[int, int, Tuple[int, ...]]:
    """(query block, head, windows) of CTA ``cta`` of the 256-token body
    at windows of ``n`` tokens: the kernel's own arithmetic
    (``wa_mma256_kernel``), for the tests."""
    blocks = mma256_query_blocks(n)
    qb, rest = cta % blocks, cta // blocks
    head, grp = rest % heads, rest // heads
    first = (grp // runs) * windows_per_cta
    n = min(windows_per_cta, total_windows // runs - first)
    return qb, head, tuple((first + i) * runs + grp % runs for i in range(n))


def tokens_fwd_plan(total_windows: int, heads: int, sms: int
                    ) -> Tuple[int, int]:
    """(windows per CTA, CTAs) of the tensor-core K4: K5's grid
    (``nhwc_fwd_plan``), heads of a run of windows on neighbouring CTAs, so
    that K4a's CTAs that share a window's mask run together."""
    return nhwc_fwd_plan(total_windows, heads, sms)


def tokens_fwd_cta_work(cta: int, heads: int, windows_per_cta: int,
                        total_windows: int) -> Tuple[int, int, int]:
    """(head, first window, windows) of CTA ``cta`` of the tensor-core K4
    (``wa_tokens_mma_kernel``), for the tests."""
    return nhwc_fwd_cta_work(cta, heads, windows_per_cta, total_windows)


def nhwc_fwd_plan(total_windows: int, heads: int, sms: int
                  ) -> Tuple[int, int]:
    """(windows per CTA, CTAs) of the tensor-core K5: runs of windows long
    enough that the grid is about 8 CTAs per SM (two waves at the 4 CTAs
    per SM its registers allow), at most 16 windows, so that each CTA reads
    its head's bias once for many windows; one window per CTA when there
    are fewer than 8 window-heads per SM."""
    wpc = -(-total_windows * heads // (8 * sms))
    wpc = max(1, min(MMA_MAX_WINDOWS_PER_CTA, wpc))
    return wpc, heads * -(-total_windows // wpc)


def nhwc_fwd_cta_work(cta: int, heads: int, windows_per_cta: int,
                      total_windows: int) -> Tuple[int, int, int]:
    """(head, first window, windows) of CTA ``cta``: the kernel's own
    arithmetic (``wa_nhwc_mma_kernel``), for the tests."""
    first = (cta // heads) * windows_per_cta
    return cta % heads, first, min(windows_per_cta, total_windows - first)


def nhwc_bwd_body(dtype: torch.dtype, hd: int, n: int) -> str:
    """Which K6 body runs, by K5's rule (``nhwc_fwd_body``): "mma" (bf16
    windows of 64 tokens, the tensor-core body of
    ``csrc/window_attn_nhwc_bwd_mma.cu``; bf16 windows of 256 tokens at a
    head dim that is a multiple of 16, ``csrc/window_attn_mma256_bwd.cu``)
    or "simt" (fp32, the other bf16 windows past 64 tokens:
    ``csrc/window_attn_bwd.cu``)."""
    return nhwc_fwd_body(dtype, hd, n)


def simt_bwd_smem(n: int, hd: int, elem: int) -> int:
    """Shared memory of the SIMT K6 (csrc ``bwd_smem_bytes``): q, k, v and
    g of one window-head in the operands' type, rows padded to hd + 1, the
    row statistics and two per-warp rows of N floats, the labels."""
    return 4 * n * (hd + 1) * elem + (3 * n + 16 * n) * 4 + 4 * n


def simt_bwd_max_head_dim(n: int, elem: int) -> int:
    """The largest head dim (up to 64) whose window of ``n`` tokens the
    SIMT K6 holds in a block's shared memory."""
    return max([hd for hd in range(1, MAX_HEAD_DIM + 1)
                if simt_bwd_smem(n, hd, elem) <= MAX_SMEM], default=0)


def nhwc_bwd_plan(total_windows: int, heads: int, sms: int
                  ) -> Tuple[int, int]:
    """(windows per CTA, CTAs) of the tensor-core K6, on K5's grid: one wave
    at the 2 CTAs per SM its registers allow, at most 16 windows per CTA. Each CTA writes one 64 x 64
    fp32 d(rel) partial (16 KB) that the in-order sum reads back, so a run
    holds at least 3 windows: at head dim 32 a window-head moves 28 KB, and
    the partials stay under a fifth of the call's bytes."""
    wpc = -(-total_windows * heads // (2 * sms))
    wpc = max(MMA_BWD_MIN_WINDOWS_PER_CTA, min(MMA_MAX_WINDOWS_PER_CTA, wpc))
    wpc = min(wpc, total_windows)
    return wpc, heads * -(-total_windows // wpc)


def nhwc_bwd_cta_work(cta: int, heads: int, windows_per_cta: int,
                      total_windows: int) -> Tuple[int, int, int]:
    """(head, first window, windows) of CTA ``cta`` of the tensor-core K6
    (``wa_nhwc_bwd_mma_kernel``: K5's grid), for the tests; the CTA writes
    its d(rel) partial to row ``cta`` of the partials."""
    return nhwc_fwd_cta_work(cta, heads, windows_per_cta, total_windows)


def mma256_bwd_plan(total_windows: int, heads: int, hd: int, sms: int
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((windows per CTA, CTAs) of kernel A, (windows per CTA, CTAs) of
    kernel B) of the 256-token tensor-core K6
    (``csrc/window_attn_mma256_bwd.cu``), both on the grid of
    ``mma256_bwd_cta_work``. Each run of kernel A writes one d(rel) partial
    of nH x 256 x 256 fp32 (2 MB at 8 heads) that the in-order sum reads
    back, so A takes as few, long runs as keep the partials under a fifth
    of the call's bytes (q, k, v, g, dq, dk, dv in bf16), at most one wave
    at the 1 CTA per SM its shared memory allows, and at least one run.
    Kernel B writes no partial: runs that make about one wave at 2 CTAs per
    SM."""
    blocks, n = MMA256_QUERY_BLOCKS, MMA256_TOKENS
    call = 7 * total_windows * heads * n * hd * 2
    partial = heads * n * n * 4
    groups = max(1, min(sms // (blocks * heads), total_windows))
    while groups > 1 and 5 * groups * partial >= call:
        groups -= 1
    wpc_a = -(-total_windows // groups)
    wpc_b = max(1, -(-total_windows * heads * blocks // (2 * sms)))
    return ((wpc_a, blocks * heads * -(-total_windows // wpc_a)),
            (wpc_b, blocks * heads * -(-total_windows // wpc_b)))


def mma256_bwd_cta_work(cta: int, heads: int, windows_per_cta: int,
                        total_windows: int
                        ) -> Tuple[int, int, Tuple[int, ...]]:
    """(block, head, windows) of CTA ``cta`` of either kernel of the
    256-token K6: the kernels' own arithmetic, for the tests. The block is
    kernel A's query block or kernel B's key block; kernel A's CTA writes
    those 64 rows of head ``head`` of partial ``cta // (4 heads)``."""
    return mma256_cta_work(cta, heads, windows_per_cta, total_windows)


def _lib(name: str) -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library
    return load_library(name)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    lib = _lib("window_attn_fwd")
    lib.window_attn_fwd_tokens_mask.argtypes = (
        [_P] * 6 + [_I] * 6 + [_F, _P])
    lib.window_attn_fwd_tokens_geo.argtypes = (
        [_P] * 5 + [_I] * 8 + [_F, _P])
    lib.window_attn_fwd_nhwc.argtypes = [_P] * 5 + [_I] * 11 + [_F, _P]
    for fn in (lib.window_attn_fwd_tokens_mask,
               lib.window_attn_fwd_tokens_geo, lib.window_attn_fwd_nhwc):
        fn.restype = ctypes.c_int
    lib.window_attn_error_string.argtypes = [_I]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _mma_library() -> ctypes.CDLL:
    lib = _lib("window_attn_nhwc_mma")
    lib.window_attn_nhwc_mma.argtypes = [_P] * 5 + [_I] * 10 + [_F, _P]
    lib.window_attn_nhwc_mma.restype = ctypes.c_int
    lib.window_attn_nhwc_mma_error_string.argtypes = [_I]
    lib.window_attn_nhwc_mma_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _tokens_mma_library() -> ctypes.CDLL:
    lib = _lib("window_attn_tokens_mma")
    lib.window_attn_tokens_mma_mask.argtypes = [_P] * 6 + [_I] * 6 + [_F, _P]
    lib.window_attn_tokens_mma_geo.argtypes = [_P] * 5 + [_I] * 8 + [_F, _P]
    for fn in (lib.window_attn_tokens_mma_mask,
               lib.window_attn_tokens_mma_geo):
        fn.restype = ctypes.c_int
    lib.window_attn_tokens_mma_error_string.argtypes = [_I]
    lib.window_attn_tokens_mma_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _mma256_library() -> ctypes.CDLL:
    lib = _lib("window_attn_mma256")
    lib.window_attn_tokens_mma256_mask.argtypes = (
        [_P] * 6 + [_I] * 6 + [_F, _P])
    lib.window_attn_tokens_mma256_geo.argtypes = (
        [_P] * 5 + [_I] * 8 + [_F, _P])
    lib.window_attn_nhwc_mma256.argtypes = [_P] * 5 + [_I] * 10 + [_F, _P]
    for fn in (lib.window_attn_tokens_mma256_mask,
               lib.window_attn_tokens_mma256_geo,
               lib.window_attn_nhwc_mma256):
        fn.restype = ctypes.c_int
    lib.window_attn_mma256_error_string.argtypes = [_I]
    lib.window_attn_mma256_error_string.restype = ctypes.c_char_p
    lib.window_attn_mma256_occupancy.argtypes = [_I]
    lib.window_attn_mma256_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _lib("window_attn_bwd")
    lib.window_attn_bwd_nhwc.argtypes = [_P] * 10 + [_I] * 12 + [_F, _P]
    lib.window_attn_bwd_nhwc.restype = ctypes.c_int
    lib.window_attn_bwd_error_string.argtypes = [_I]
    lib.window_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_mma_library() -> ctypes.CDLL:
    lib = _lib("window_attn_nhwc_bwd_mma")
    lib.window_attn_nhwc_bwd_mma.argtypes = [_P] * 10 + [_I] * 10 + [_F, _P]
    lib.window_attn_nhwc_bwd_mma.restype = ctypes.c_int
    lib.window_attn_nhwc_bwd_mma_error_string.argtypes = [_I]
    lib.window_attn_nhwc_bwd_mma_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_mma256_library() -> ctypes.CDLL:
    lib = _lib("window_attn_mma256_bwd")
    lib.window_attn_nhwc_mma256_bwd.argtypes = (
        [_P] * 12 + [_I] * 11 + [_F, _P])
    lib.window_attn_nhwc_mma256_bwd.restype = ctypes.c_int
    lib.window_attn_mma256_bwd_error_string.argtypes = [_I]
    lib.window_attn_mma256_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _run(lib, fn, err_fn, kind: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{kind} launch failed: "
                           f"{err_fn(err).decode()} ({err})")
    LAUNCHES[kind] += 1


def _launch_tokens(q, k, v, rel_bias, shift_mask, scale: float,
                   num_windows: int, geometry: Optional[Geometry]):
    """K4b when ``geometry`` is given, else K4a with ``shift_mask``: a
    tensor-core body (of 64 tokens, or of 144 and 256) or the SIMT body by
    ``tokens_fwd_body``; all count under k4a / k4b, the tensor-core
    launches also under k4a_mma / k4b_mma."""
    nwt, nh, n, hd = q.shape
    out = torch.empty_like(q)
    kind = "k4a" if geometry is None else "k4b"
    if tokens_fwd_body(q.dtype, hd, n) == "mma":
        if any(t.data_ptr() % 16 for t in (q, k, v, out)):
            raise ValueError("the tensor-core K4 copies 16 bytes at a time: "
                             "q, k, v and out must start 16-byte aligned")
        sms = _sm_count(q.device)
        if n in (MMA144_TOKENS, MMA256_TOKENS):
            if any(t.data_ptr() % 8 for t in (rel_bias, shift_mask)
                   if t is not None):
                raise ValueError("the 144- and 256-token K4 reads rel and "
                                 "the mask 8 bytes at a time: they must "
                                 "start 8-byte aligned")
            lib = _mma256_library()
            fn_mask, fn_geo = (lib.window_attn_tokens_mma256_mask,
                               lib.window_attn_tokens_mma256_geo)
            err = lib.window_attn_mma256_error_string
            wpc, _ = mma256_plan(nwt, nh, sms,
                                 num_windows if geometry is None else 1, n)
        else:
            lib = _tokens_mma_library()
            fn_mask, fn_geo = (lib.window_attn_tokens_mma_mask,
                               lib.window_attn_tokens_mma_geo)
            err = lib.window_attn_tokens_mma_error_string
            wpc, _ = tokens_fwd_plan(nwt, nh, sms)
        if geometry is not None:
            hp, wp, ws, shift = geometry
            _run(lib, fn_geo, err, kind, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
                 out.data_ptr(), nwt, nh, hd, hp, wp, ws, shift, wpc, scale)
        else:
            _run(lib, fn_mask, err, kind, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
                 shift_mask.data_ptr(), out.data_ptr(), nwt, num_windows, nh,
                 n, hd, wpc, scale)
        LAUNCHES[kind + "_mma"] += 1
        return out
    lib = _fwd_library()
    bf16 = int(q.dtype == torch.bfloat16)
    if geometry is not None:
        hp, wp, ws, shift = geometry
        _run(lib, lib.window_attn_fwd_tokens_geo, lib.window_attn_error_string,
             kind, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             rel_bias.data_ptr(), out.data_ptr(), bf16, nwt, nh, hd, hp, wp,
             ws, shift, scale)
    else:
        _run(lib, lib.window_attn_fwd_tokens_mask,
             lib.window_attn_error_string, kind, q.device, q.data_ptr(),
             k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
             shift_mask.data_ptr(), out.data_ptr(), bf16, nwt, num_windows,
             nh, n, hd, scale)
    return out


def _launch_nhwc(operands, rel_bias, scale: float, geometry: Geometry,
                 pad_hw):
    """K5: a tensor-core body (windows of 8 or of 16) or the SIMT body by
    ``nhwc_fwd_body``; all count under k5_fused / k5_split, the
    tensor-core launches also under k5_fused_mma / k5_split_mma."""
    hp, wp, ws, shift = geometry
    fused = len(operands) == 1
    q, k, v = (operands * 3) if fused else operands
    b, _, _, cx = q.shape
    c = cx // 3 if fused else cx
    nh = rel_bias.shape[0]
    ph, pw = pad_hw or (0, 0)
    out = q.new_empty((b, hp, wp, c))
    kind = "k5_fused" if fused else "k5_split"
    if nhwc_fwd_body(q.dtype, c // nh, ws * ws) == "mma":
        total, sms = b * (hp // ws) * (wp // ws), _sm_count(q.device)
        if ws * ws == MMA256_TOKENS:
            lib = _mma256_library()
            fn, err = (lib.window_attn_nhwc_mma256,
                       lib.window_attn_mma256_error_string)
            wpc, _ = mma256_plan(total, nh, sms)
        else:
            lib = _mma_library()
            fn, err = (lib.window_attn_nhwc_mma,
                       lib.window_attn_nhwc_mma_error_string)
            wpc, _ = nhwc_fwd_plan(total, nh, sms)
        _run(lib, fn, err, kind, q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), rel_bias.data_ptr(), out.data_ptr(), int(fused),
             b, nh, c, hp, wp, shift, ph, pw, wpc, scale)
        LAUNCHES[kind + "_mma"] += 1
        return out
    lib = _fwd_library()
    _run(lib, lib.window_attn_fwd_nhwc, lib.window_attn_error_string, kind,
         q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         rel_bias.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
         int(fused), b, nh, c, hp, wp, ws, shift, ph, pw, scale)
    return out


def bwd_windows_per_block(total_windows: int, heads: int, n: int, hd: int,
                          elem: int, sms: int) -> int:
    """Windows one SIMT K6 block walks through (adding its d(rel) share to
    its own N x N partial): one wave of blocks at the blocks per SM that
    its shared memory allows (at most 4), at most 16 windows; each block
    writes one partial, so fewer, longer blocks write fewer bytes."""
    per_sm = max(1, min(4, MAX_SMEM // (simt_bwd_smem(n, hd, elem) + 1024)))
    return max(1, min(16, -(-total_windows * heads // (per_sm * sms))))


def _launch_nhwc_bwd(operands, rel_bias, g, scale: float, geometry: Geometry,
                     pad_hw):
    """K6: a tensor-core body (windows of 8 or of 16) or the SIMT body by
    ``nhwc_bwd_body``; all count under k6_fused / k6_split, the
    tensor-core launches also under k6_fused_mma / k6_split_mma."""
    hp, wp, ws, shift = geometry
    fused = len(operands) == 1
    q, k, v = (operands * 3) if fused else operands
    b, _, _, cx = q.shape
    c = cx // 3 if fused else cx
    nh, n = rel_bias.shape[0], ws * ws
    if g.shape != (b, hp, wp, c) or g.dtype != q.dtype \
            or not g.is_contiguous() or g.device != q.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype}: want "
                         f"contiguous {(b, hp, wp, c)} {q.dtype}")
    grads = [torch.empty_like(t) for t in operands]
    dq, dk, dv = (grads * 3) if fused else grads
    total = b * (hp // ws) * (wp // ws)
    drel = torch.empty((nh, n, n), dtype=torch.float32, device=q.device)
    ph, pw = pad_hw or (0, 0)
    kind = "k6_fused" if fused else "k6_split"
    if nhwc_bwd_body(q.dtype, c // nh, n) == "mma":
        if any(t.data_ptr() % 16 for t in (*operands, g, *grads)) \
                or rel_bias.data_ptr() % 8:
            raise ValueError("the tensor-core K6 copies 16 bytes at a time: "
                             "operands, cotangent and gradients must start "
                             "16-byte aligned")
        if n == MMA256_TOKENS:
            lib = _bwd_mma256_library()
            (wpc_a, ctas_a), (wpc_b, _) = mma256_bwd_plan(
                total, nh, c // nh, _sm_count(q.device))
            dev = q.device
            lse, rsum = (torch.empty((total, nh, n), dtype=torch.float32,
                                     device=dev) for _ in range(2))
            partial = torch.empty(
                (ctas_a // MMA256_QUERY_BLOCKS, n, n), dtype=torch.float32,
                device=dev)
            _run(lib, lib.window_attn_nhwc_mma256_bwd,
                 lib.window_attn_mma256_bwd_error_string, kind, dev,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 rel_bias.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), lse.data_ptr(), rsum.data_ptr(),
                 partial.data_ptr(), drel.data_ptr(), int(fused), b, nh, c,
                 hp, wp, shift, ph, pw, wpc_a, wpc_b, scale)
            LAUNCHES[kind + "_mma"] += 1
            return (*grads, drel)
        lib = _bwd_mma_library()
        wpc, ctas = nhwc_bwd_plan(total, nh, _sm_count(q.device))
        partial = torch.empty((ctas, n, n), dtype=torch.float32,
                              device=q.device)
        _run(lib, lib.window_attn_nhwc_bwd_mma,
             lib.window_attn_nhwc_bwd_mma_error_string, kind, q.device,
             q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             rel_bias.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             partial.data_ptr(), drel.data_ptr(), int(fused), b, nh, c, hp,
             wp, shift, ph, pw, wpc, scale)
        LAUNCHES[kind + "_mma"] += 1
        return (*grads, drel)
    elem = q.element_size()
    if simt_bwd_smem(n, c // nh, elem) > MAX_SMEM:
        raise ValueError(
            f"the SIMT K6 holds a window in shared memory: at {n} tokens it "
            f"takes {q.dtype} head dims up to "
            f"{simt_bwd_max_head_dim(n, elem)}, got {c // nh}")
    lib = _bwd_library()
    wpb = bwd_windows_per_block(total, nh, n, c // nh, elem,
                                _sm_count(q.device))
    partial = torch.empty((-(-total // wpb), nh, n, n), dtype=torch.float32,
                          device=q.device)
    _run(lib, lib.window_attn_bwd_nhwc, lib.window_attn_bwd_error_string,
         kind, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         g.data_ptr(), rel_bias.data_ptr(), dq.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), partial.data_ptr(), drel.data_ptr(),
         int(q.dtype == torch.bfloat16), int(fused), b, nh, c, hp, wp, ws,
         shift, ph, pw, wpb, scale)
    return (*grads, drel)


def window_attention_nhwc_bwd(operands, rel_bias, g, scale: float,
                              geometry: Geometry, pad_hw=None):
    """K6 for a given cotangent (in the operands' dtype): the backward
    kernel for CUDA tensors (counted in ``LAUNCHES``), the plain version
    for CPU tensors. Returns (d(operands)..., d(rel) fp32)."""
    geometry = _int_geometry(geometry)
    pad_hw = _pad_or_none(pad_hw, geometry)
    dev = operands[0].device
    if dev.type == "cpu":
        return window_attention_nhwc_bwd_torch(operands, rel_bias, g,
                                               float(scale), geometry, pad_hw)
    if dev.type != "cuda":
        raise RuntimeError(f"no window-attention kernel for device {dev}")
    _check_nhwc(operands, rel_bias, geometry)
    return _launch_nhwc_bwd(operands, rel_bias, g, float(scale), geometry,
                            pad_hw)


# ------------------------------------------------------------------ autograd
class WindowAttentionFunction(torch.autograd.Function):
    """K4a / K4b forward (plain version on the CPU); the backward is the JAX
    package's fp32 recompute in torch ops (``_fused_wa_bwd``), with the
    -100 shift mask for the geometry variant as JAX builds it."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, rel_bias, shift_mask, scale, num_windows,
                geometry):
        ctx.scale, ctx.num_windows, ctx.geometry = scale, num_windows, \
            geometry
        ctx.save_for_backward(q, k, v, rel_bias, shift_mask)
        return _tokens_forward(q, k, v, rel_bias, shift_mask, scale,
                               num_windows, geometry)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, rel_bias, shift_mask = ctx.saved_tensors
        if ctx.geometry is not None:
            hp, wp, ws, shift = ctx.geometry
            shift_mask = (window_mask(hp, wp, ws, shift, None, q.device)
                          if shift > 0 else q.new_zeros(
                              (ctx.num_windows,) + q.shape[2:3] * 2,
                              dtype=torch.float32))
        dq, dk, dv, drel = window_attention_bwd_torch(
            q, k, v, rel_bias, shift_mask, g, ctx.scale, ctx.num_windows)
        return dq, dk, dv, drel, None, None, None, None


class WindowAttentionNHWCFunction(torch.autograd.Function):
    """K5 forward, K6 backward on CUDA; the plain versions of both on the
    CPU. The cotangent is cast to the operands' dtype and made contiguous
    first, as JAX casts it before its K6. d(rel) flows on through the
    bias-table gather in autograd."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, rel_bias, scale, geometry, pad_hw, *operands):
        ctx.scale, ctx.geometry, ctx.pad_hw = scale, geometry, pad_hw
        ctx.save_for_backward(rel_bias, *operands)
        return _nhwc_forward(operands, rel_bias, scale, geometry, pad_hw)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        rel_bias, *operands = ctx.saved_tensors
        g = g.to(operands[0].dtype).contiguous()
        if g.device.type == "cuda":
            *grads, drel = _launch_nhwc_bwd(operands, rel_bias, g, ctx.scale,
                                            ctx.geometry, ctx.pad_hw)
        else:
            *grads, drel = window_attention_nhwc_bwd_torch(
                operands, rel_bias, g, ctx.scale, ctx.geometry, ctx.pad_hw)
        return (drel.to(rel_bias.dtype), None, None, None, *grads)


# ----------------------------------------------------------- entry points
def _tokens_forward(q, k, v, rel_bias, shift_mask, scale, num_windows,
                    geometry):
    if q.device.type == "cpu":
        return window_attention_torch(q, k, v, rel_bias, shift_mask, scale,
                                      num_windows, geometry)
    return _launch_tokens(q, k, v, rel_bias, shift_mask, scale, num_windows,
                          geometry)


def _nhwc_forward(operands, rel_bias, scale, geometry, pad_hw):
    if operands[0].device.type == "cpu":
        return window_attention_nhwc_plain(operands, rel_bias, scale,
                                           geometry, pad_hw)
    return _launch_nhwc(operands, rel_bias, scale, geometry, pad_hw)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no window-attention kernel for device {dev}")


def window_attention(q, k, v, rel_bias, shift_mask, scale: float,
                     num_windows: int, geometry: Optional[Geometry] = None
                     ) -> torch.Tensor:
    """Token-major window attention, the JAX ``fused_window_attention``
    contract: q/k/v (nWt, nH, N, hd) with nWt = B * num_windows, rel_bias
    (nH, N, N), shift_mask (num_windows, N, N) or None. With ``geometry``
    = (Hp, Wp, ws, shift) the region mask is derived in the kernel (K4b)
    and shift_mask is ignored; else the mask tensor is added (K4a, zeros
    when None)."""
    _check_device(q.device)
    scale, num_windows = float(scale), int(num_windows)
    if geometry is not None:
        geometry = _int_geometry(geometry)
        shift_mask = None
    elif shift_mask is None:
        shift_mask = q.new_zeros((num_windows,) + q.shape[2:3] * 2,
                                 dtype=torch.float32)
    if q.device.type == "cuda":
        _check_tokens(q, k, v, rel_bias, num_windows)
        if shift_mask is not None and (
                shift_mask.dtype != torch.float32
                or not shift_mask.is_contiguous()
                or tuple(shift_mask.shape) != (num_windows,) + q.shape[2:3] * 2):
            raise ValueError(f"shift_mask {tuple(shift_mask.shape)} "
                             f"{shift_mask.dtype}: want contiguous float32 "
                             f"{(num_windows,) + q.shape[2:3] * 2}")
    if _wants_grad(q, k, v, rel_bias):
        return WindowAttentionFunction.apply(q, k, v, rel_bias, shift_mask,
                                             scale, num_windows, geometry)
    return _tokens_forward(q, k, v, rel_bias, shift_mask, scale, num_windows,
                           geometry)


def _nhwc(operands, rel_bias, scale, geometry, pad_hw):
    _check_device(operands[0].device)
    if operands[0].device.type == "cuda":
        _check_nhwc_fwd(operands, rel_bias, geometry)
    if _wants_grad(rel_bias, *operands):
        return WindowAttentionNHWCFunction.apply(rel_bias, scale, geometry,
                                                 pad_hw, *operands)
    return _nhwc_forward(operands, rel_bias, scale, geometry, pad_hw)


def window_attention_nhwc(qkv, rel_bias, scale: float,
                          geometry: Geometry) -> torch.Tensor:
    """NHWC window attention from the fused qkv map, the JAX
    ``fused_window_attention_nhwc`` contract: qkv (B, Hp, Wp, 3C), rolled
    already when shifted; geometry (Hp, Wp, ws, shift). Returns
    (B, Hp, Wp, C). Padded tokens attend like real ones."""
    return _nhwc((qkv,), rel_bias, float(scale), _int_geometry(geometry),
                 None)


def window_attention_nhwc_split(q, k, v, rel_bias, scale: float,
                                geometry: Geometry,
                                pad_hw=None) -> torch.Tensor:
    """Split-projection NHWC window attention, the JAX
    ``fused_window_attention_nhwc_split`` contract: q/k/v (B, Hp, Wp, C)
    (padded and rolled when shifted), ``pad_hw`` = (h, w) real extents for
    the canvas-pad labels; (Hp, Wp) or None means no pad tokens."""
    geometry = _int_geometry(geometry)
    return _nhwc((q, k, v), rel_bias, float(scale), geometry,
                 _pad_or_none(pad_hw, geometry))


window_attention.wants_geometry = True
window_attention_nhwc.wants_nhwc = True
window_attention_nhwc_split.wants_nhwc = True
