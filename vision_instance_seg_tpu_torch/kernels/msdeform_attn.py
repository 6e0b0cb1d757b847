"""Multi-scale deformable-attention sampling: CUDA kernels and plain versions.

Port of ``vision_instance_seg_tpu/kernels/msdeform_attn.py``. The CUDA
kernel in ``csrc/msdeform_attn_fwd.cu`` replaces the TPU forward kernel
``_encoder_level_pallas`` (entry ``ms_deform_attn_encoder_pallas``, dispatch
``fused_ms_deform_attn``); the one in ``csrc/msdeform_attn_bwd.cu`` replaces
the three TPU backward kernels behind ``_encoder_pallas_diff``
(``_encoder_level_bwd_lw_pallas``, ``_encoder_bwd_v_dense_pallas``,
``_encoder_level_bwd_v_pallas``). Both gather (and the backward scatters
with atomics) where the TPU kernels built one-hot selection matmuls over
halo windows, so they serve any queries.

Contract of both functions below (the JAX ``ms_deform_attn_core_jnp``'s):
value (B, sum HW, nH, hd) with the levels concatenated along axis 1;
spatial_shapes [(H_l, W_l)] per level; locations (B, Q, nH, L, P, 2)
normalized to [0, 1] (align_corners=False); weights (B, Q, nH, L, P).
Returns (B, Q, nH * hd) fp32. Corners outside the map contribute zero.

``ms_deform_attn`` is the wrapper the model calls: a CPU tensor goes to the
plain version (and gets autograd through it), a CUDA tensor to the kernel,
through ``MSDeformAttnFunction`` when a gradient is wanted (backward = the
backward kernel), and nothing falls back. ``ms_deform_attn_bwd`` is the
backward's own wrapper. Gradients follow the JAX contract: d(value) in the
value's dtype, d(locations) and d(weights) fp32; ``floor`` and the corner
clip carry no gradient; corners off the map contribute nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

# The JAX kernel's halo: grid-query sampling offsets are clamped to this
# many pixels of the sampled level when TPU.USE_PALLAS_DEFORM_ATTN is set
# (models/deform_attn.MSDeformAttn), so both packages compute one function.
DEFAULT_HALO = 6
MAX_LEVELS = 8               # csrc MSDA_MAX_LEVELS
FWD_QUERIES_PER_CTA = 8     # K1: consecutive queries of one image per CTA
FWD_MAX_THREADS = 256       # K1: largest CTA (csrc refuses more)
BWD_QUERIES_PER_CTA = 4     # backward: the same, for its CTAs
BWD_MAX_THREADS = 256       # backward: largest CTA (csrc refuses more)
BWD_MAX_VECTOR = 4          # backward: channels a vector at most (csrc
                            # kBwdMaxVector; it refuses more)


def ms_deform_attn_core_torch(value: torch.Tensor,
                              spatial_shapes: Sequence[Tuple[int, int]],
                              locations: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sampling core: the CPU path and the kernel's golden.

    Mirrors the JAX ``ms_deform_attn_core_jnp`` with ``torch.gather`` on the
    flattened H*W axis, in fp32 whatever the value dtype.
    """
    b, _, nh, hd = value.shape
    q, p = locations.shape[1], locations.shape[4]
    out = torch.zeros((b, q, nh, hd), dtype=torch.float32,
                      device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()            # (B, HW, nH, hd)
        start += h * w
        loc = locations[:, :, :, lvl].float()                # (B, Q, nH, P, 2)
        aw = weights[:, :, :, lvl].float()                   # (B, Q, nH, P)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        xf, yf = torch.floor(x), torch.floor(y)
        lx, ly = x - xf, y - yf
        x0 = xf.clamp(-2, w).long()
        y0 = yf.clamp(-2, h).long()
        sampled = torch.zeros((b, q, p, nh, hd), dtype=torch.float32,
                              device=value.device)
        for dy, wy in ((0, 1.0 - ly), (1, ly)):
            for dx, wx in ((0, 1.0 - lx), (1, lx)):
                yi, xi = y0 + dy, x0 + dx
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
                idx = idx.permute(0, 1, 3, 2).reshape(b, q * p, nh, 1)
                g = torch.gather(v, 1, idx.expand(-1, -1, -1, hd))
                wgt = torch.where(valid, wy * wx, 0.0).permute(0, 1, 3, 2)
                sampled += g.view(b, q, p, nh, hd) * wgt[..., None]
        out += (sampled * aw.permute(0, 1, 3, 2)[..., None]).sum(2)
    return out.reshape(b, q, nh * hd)


def ms_deform_attn_bwd_torch(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             locations: torch.Tensor, weights: torch.Tensor,
                             grad_out: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain backward of ``ms_deform_attn_core_torch``, written out (not
    autograd): the CPU path and the backward kernel's golden.

    grad_out (B, Q, nH * hd). Returns (d_value in the value's dtype,
    d_locations fp32, d_weights fp32). Per sample and corner, with
    gv = grad . value_corner over the head's channels: d_weights sums
    w_corner * gv; d_locations is the level's W (H) times the attention
    weight times the bilinear weights' x (y) derivative against gv;
    d_value scatters weight * w_corner * grad onto the corner.
    """
    b, s, nh, hd = value.shape
    q, p = locations.shape[1], locations.shape[4]
    g = grad_out.float().reshape(b, q, nh, 1, hd)
    d_value = torch.zeros((b, s, nh, hd), dtype=torch.float32,
                          device=value.device)
    d_loc = torch.zeros(locations.shape, dtype=torch.float32,
                        device=value.device)
    d_aw = torch.zeros(weights.shape, dtype=torch.float32,
                       device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()            # (B, HW, nH, hd)
        dv = d_value[:, start:start + h * w]
        start += h * w
        loc = locations[:, :, :, lvl].float()                # (B, Q, nH, P, 2)
        aw = weights[:, :, :, lvl].float()                   # (B, Q, nH, P)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        xf = torch.floor(x).clamp(-2, w)
        yf = torch.floor(y).clamp(-2, h)
        lx, ly = x - xf, y - yf
        x0, y0 = xf.long(), yf.long()
        gv, wc = {}, {}
        for dy, wy in ((0, 1.0 - ly), (1, ly)):
            for dx, wx in ((0, 1.0 - lx), (1, lx)):
                yi, xi = y0 + dy, x0 + dx
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
                idx = idx.permute(0, 1, 3, 2).reshape(b, q * p, nh, 1)
                idx = idx.expand(-1, -1, -1, hd)
                vc = torch.gather(v, 1, idx).view(b, q, p, nh, hd)
                vc = vc.permute(0, 1, 3, 2, 4)               # (B, Q, nH, P, hd)
                gv[dy, dx] = torch.where(valid, (vc * g).sum(-1), 0.0)
                wc[dy, dx] = torch.where(valid, wy * wx, 0.0)
                contrib = (aw * wc[dy, dx])[..., None] * g   # (B, Q, nH, P, hd)
                dv.scatter_add_(1, idx, contrib.permute(0, 1, 3, 2, 4)
                                .reshape(b, q * p, nh, hd))
        d_aw[:, :, :, lvl] = sum(wc[k] * gv[k] for k in gv)
        d_lx = ((1.0 - ly) * (gv[0, 1] - gv[0, 0])
                + ly * (gv[1, 1] - gv[1, 0]))
        d_ly = ((1.0 - lx) * (gv[1, 0] - gv[0, 0])
                + lx * (gv[1, 1] - gv[0, 1]))
        d_loc[:, :, :, lvl, :, 0] = w * aw * d_lx
        d_loc[:, :, :, lvl, :, 1] = h * aw * d_ly
    return d_value.to(value.dtype), d_loc, d_aw


def _check_inputs(value, spatial_shapes, locations, weights):
    b, s, nh, hd = value.shape
    nl = len(spatial_shapes)
    q = locations.shape[1]
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value dtype {value.dtype}: float32 or bfloat16")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("locations and weights must be float32")
    if locations.dim() != 6 or locations.shape[:4] != (b, q, nh, nl) \
            or locations.shape[5] != 2:
        raise ValueError(f"locations {tuple(locations.shape)} vs value "
                         f"{tuple(value.shape)} and {nl} levels")
    if tuple(weights.shape) != tuple(locations.shape[:5]):
        raise ValueError(f"weights {tuple(weights.shape)} vs locations "
                         f"{tuple(locations.shape)}")
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value holds {s} tokens, spatial_shapes "
                         f"{list(spatial_shapes)} say otherwise")
    if not 1 <= nl <= MAX_LEVELS or nh * hd > 1024:
        raise ValueError(f"{nl} levels (max {MAX_LEVELS}) or {nh}x{hd} "
                         "channels (max 1024) not supported by the kernel")
    for name, t in (("value", value), ("locations", locations),
                    ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
    if locations.data_ptr() % 8:
        raise ValueError("locations must be 8-byte aligned (float2 loads)")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library

    return bind_fwd(load_library("msdeform_attn_fwd"))


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares K1's C entry points on a library built from
    ``csrc/msdeform_attn_fwd.cu`` (or a version of it)."""
    lib.msdeform_attn_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.msdeform_attn_fwd.restype = ctypes.c_int
    lib.msdeform_attn_error_string.argtypes = [ctypes.c_int]
    lib.msdeform_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library

    return bind_bwd(load_library("msdeform_attn_bwd"))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the backward's C entry points on a library built from
    ``csrc/msdeform_attn_bwd.cu`` (or a version of it)."""
    lib.msdeform_attn_bwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.msdeform_attn_bwd.restype = ctypes.c_int
    lib.msdeform_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.msdeform_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _level_array(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(d) for hw in spatial_shapes for d in hw])


def fwd_vector_width(dtype: torch.dtype, hd: int, data_ptr: int) -> int:
    """Channels per lane of K1 (csrc ``msdeform_attn_fwd``'s ``vec``): the
    widest of 16, 8, 4 or 2 bytes of value channels (8, 4, 2, 1 in bf16; 4,
    2, 1 in fp32) that divides the head dim and the value's address, so that
    every corner row a lane reads is one aligned vector load."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value dtype {dtype}: float32 or bfloat16")
    elem = 2 if dtype == torch.bfloat16 else 4
    if data_ptr % elem:
        raise ValueError(f"value at {data_ptr:#x} is not aligned to its "
                         f"{elem}-byte elements")
    vec = 16 // elem
    while vec > 1 and (hd % vec or data_ptr % (vec * elem)):
        vec //= 2
    return vec


def fwd_launch_plan(b: int, q: int, nh: int, hd: int, vec: int,
                    queries_per_cta: int = FWD_QUERIES_PER_CTA
                    ) -> Tuple[Tuple[int, int], int]:
    """K1's grid and CTA size, as ``_launch_cuda`` passes them to the
    kernel: ((ceil(Q / qpc), B) CTAs, threads). A CTA takes
    ``queries_per_cta`` consecutive queries of one image, images on the
    slow grid axis; its items are (query, head, lane) with hd / vec lanes
    per (query, head), at most ``FWD_MAX_THREADS`` threads, each taking
    items t, t + threads, ... (``fwd_item``)."""
    per_cta = queries_per_cta * nh * (hd // vec)
    return ((q + queries_per_cta - 1) // queries_per_cta, b), \
        min(per_cta, FWD_MAX_THREADS)


def fwd_item(i, nq: int, nh: int, g: int):
    """Item ``i`` of a K1 CTA that holds ``nq`` queries -> (query in the CTA,
    head, lane): the mapping the kernel's loop computes for itself
    (query-major: a warp holds the heads of neighbouring queries), stated
    here for the CPU tests; lane l takes channels [l * vec, l * vec + vec)
    of the head. Works on ints and on numpy arrays."""
    return i // (nh * g), i // g % nh, i % g


def _launch_cuda(value, spatial_shapes, locations, weights, lib=None,
                 queries_per_cta: int = FWD_QUERIES_PER_CTA):
    """Launches K1 with ``fwd_launch_plan``'s plan (``lib`` and
    ``queries_per_cta`` let a bench time a version of the source or
    another plan)."""
    lib = lib or _library()
    b, s, nh, hd = value.shape
    q, nl, p = locations.shape[1], len(spatial_shapes), locations.shape[4]
    out = torch.empty((b, q, nh * hd), dtype=torch.float32,
                      device=value.device)
    vec = fwd_vector_width(value.dtype, hd, value.data_ptr())
    qpc = queries_per_cta
    (ctas, _), threads = fwd_launch_plan(b, q, nh, hd, vec, qpc)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msdeform_attn_fwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            locations.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, s, q, nh, hd, nl, p, _level_array(spatial_shapes), vec,
            qpc, ctas, threads, stream)
    if err:
        msg = lib.msdeform_attn_error_string(err).decode()
        raise RuntimeError(f"msdeform_attn_fwd launch failed: {msg} ({err})")
    ms_deform_attn.launches += 1
    return out


def _check_grad(value, locations, grad_out):
    b, _, nh, hd = value.shape
    if tuple(grad_out.shape) != (b, locations.shape[1], nh * hd):
        raise ValueError(f"grad_out {tuple(grad_out.shape)}, want "
                         f"{(b, locations.shape[1], nh * hd)}")
    if grad_out.dtype != torch.float32 or not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous float32")
    if grad_out.device != value.device:
        raise ValueError(f"grad_out on {grad_out.device}, value on "
                         f"{value.device}")
    if not bwd_takes_head_dim(nh, hd):
        raise ValueError(f"{nh} heads x head_dim {hd}: the backward kernel "
                         "takes what the TPU kernels take, any head_dim when "
                         "heads x head_dim <= 128, else a head_dim that "
                         "divides 128")


def bwd_takes_head_dim(nh: int, hd: int) -> bool:
    """The backward kernel's head dims (csrc ``msda_bwd_takes``), those of
    the TPU kernels' channel chunking: any when nH * hd <= 128, else one
    that divides 128."""
    return 1 <= hd <= 128 and (nh * hd <= 128 or 128 % hd == 0)


def bwd_vector_width(dtype: torch.dtype, hd: int, data_ptr: int,
                     max_vector: int = BWD_MAX_VECTOR) -> int:
    """Channels a vector of the backward (csrc ``msdeform_attn_bwd``'s
    ``vec``): K1's width, at most ``max_vector`` (``BWD_MAX_VECTOR``, 4;
    a bench may ask for fewer). A lane's add into a d(value) row is then
    one 16-byte fp32 vector atomic, and a group's lanes add into one
    contiguous run of the row: 8 bf16 channels a lane put each lane's two
    atomics 16 bytes apart, in twice as many 32-byte sectors of L2."""
    return min(fwd_vector_width(dtype, hd, data_ptr), max_vector)


def bwd_group(hd: int, vec: int) -> Tuple[int, int]:
    """Lanes of one (query, head) in the backward and vectors a lane takes:
    the head's hd / vec vectors rounded up to a power of two lanes, at most
    32, so that a group lies in one warp and its xor shuffles stay inside
    it (lanes past the head's vectors idle); a head of more than 32 vectors
    gives each lane ceil(vectors / 32), vectors lane, lane + 32, ...
    (``bwd_lane_channels``)."""
    vectors = hd // vec
    lanes = 1
    while lanes < min(vectors, 32):
        lanes *= 2
    return lanes, -(-vectors // lanes)


def bwd_launch_plan(b: int, q: int, nh: int, hd: int, vec: int,
                    queries_per_cta: int = BWD_QUERIES_PER_CTA
                    ) -> Tuple[Tuple[int, int], int, int, int]:
    """The backward's grid, CTA size and lane groups, as
    ``_launch_cuda_bwd`` passes them to the kernel: ((ceil(Q / qpc), B)
    CTAs, threads, lanes, chunks). A CTA takes ``queries_per_cta``
    consecutive queries of one image, images on the slow grid axis; its
    items are (query, head, lane) with ``bwd_group``'s lanes per (query,
    head), at most ``BWD_MAX_THREADS`` threads (a multiple of the lanes),
    each taking items t, t + threads, ... (``bwd_item``, K1's mapping). No
    shared memory."""
    lanes, chunks = bwd_group(hd, vec)
    per_cta = queries_per_cta * nh * lanes
    return ((q + queries_per_cta - 1) // queries_per_cta, b), \
        min(per_cta, BWD_MAX_THREADS), lanes, chunks


# the backward's items map as K1's, with its group's lanes for K1's hd / vec
bwd_item = fwd_item


def bwd_lane_channels(lane: int, lanes: int, chunks: int, hd: int,
                      vec: int) -> list:
    """The head's channels that ``lane`` of a backward group takes: vectors
    lane + k * lanes (k < chunks) below hd / vec, vec channels each; none
    for an idle lane."""
    return [c * vec + j for k in range(chunks)
            for c in [lane + k * lanes] if c < hd // vec
            for j in range(vec)]


def _launch_cuda_bwd(value, spatial_shapes, locations, weights, grad_out,
                     lib=None, queries_per_cta: int = BWD_QUERIES_PER_CTA,
                     max_vector: int = BWD_MAX_VECTOR):
    """Launches the backward with ``bwd_launch_plan``'s plan (``lib``,
    ``queries_per_cta`` and ``max_vector`` let a bench time a version of
    the source or another plan)."""
    _check_grad(value, locations, grad_out)
    lib = lib or _bwd_library()
    b, s, nh, hd = value.shape
    q, nl, p = locations.shape[1], len(spatial_shapes), locations.shape[4]
    acc = torch.empty((b, s, nh, hd), dtype=torch.float32,
                      device=value.device)
    d_value = acc if value.dtype == torch.float32 else torch.empty_like(value)
    d_loc = torch.empty_like(locations)
    d_aw = torch.empty_like(weights)
    vec = bwd_vector_width(value.dtype, hd, value.data_ptr(), max_vector)
    qpc = queries_per_cta
    (ctas, _), threads, lanes, chunks = bwd_launch_plan(b, q, nh, hd, vec, qpc)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msdeform_attn_bwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            locations.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
            acc.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
            d_aw.data_ptr(), b, s, q, nh, hd, nl, p,
            _level_array(spatial_shapes), vec, lanes, chunks, qpc, ctas,
            threads, stream)
    if err:
        msg = lib.msdeform_attn_bwd_error_string(err).decode()
        raise RuntimeError(f"msdeform_attn_bwd launch failed: {msg} ({err})")
    ms_deform_attn_bwd.launches += 1
    return d_value, d_loc, d_aw


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 forward, backward kernel backward. The model calls the core inside
    autocast (bf16 value, fp32 locations and weights); ``custom_fwd`` /
    ``custom_bwd`` run the backward under the forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, value, spatial_shapes, locations, weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locations, weights)
        return _launch_cuda(value, spatial_shapes, locations, weights)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        d_value, d_loc, d_aw = _launch_cuda_bwd(
            value, ctx.spatial_shapes, locations, weights,
            grad_out.contiguous())
        return d_value, None, d_loc, d_aw


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Sampling core the model calls (``MSDeformAttn.core_fn``).

    CUDA tensors launch the hand-written kernel (counted in
    ``ms_deform_attn.launches``), through ``MSDeformAttnFunction`` when
    autograd records; CPU tensors take the plain version.
    """
    if value.device.type == "cpu":
        return ms_deform_attn_core_torch(value, spatial_shapes, locations,
                                         weights)
    if value.device.type != "cuda":
        raise RuntimeError(f"no sampling kernel for device {value.device}")
    _check_inputs(value, spatial_shapes, locations, weights)
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if torch.is_grad_enabled() and (value.requires_grad
                                    or locations.requires_grad
                                    or weights.requires_grad):
        return MSDeformAttnFunction.apply(value, shapes, locations, weights)
    return _launch_cuda(value, shapes, locations, weights)


def ms_deform_attn_bwd(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       locations: torch.Tensor, weights: torch.Tensor,
                       grad_out: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the sampling core for a given cotangent: the backward
    kernel for CUDA tensors (counted in ``ms_deform_attn_bwd.launches``),
    the plain version for CPU tensors."""
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_torch(value, spatial_shapes, locations,
                                        weights, grad_out)
    if value.device.type != "cuda":
        raise RuntimeError(f"no sampling kernel for device {value.device}")
    _check_inputs(value, spatial_shapes, locations, weights)
    return _launch_cuda_bwd(value, spatial_shapes, locations, weights,
                            grad_out)


ms_deform_attn.launches = 0
ms_deform_attn_bwd.launches = 0
