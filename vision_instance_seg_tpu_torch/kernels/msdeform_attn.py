"""Multi-scale deformable-attention sampling: CUDA kernel and plain version.

Port of ``vision_instance_seg_tpu/kernels/msdeform_attn.py``: the CUDA
kernel in ``csrc/msdeform_attn_fwd.cu`` replaces the TPU kernel
``_encoder_level_pallas`` (entry ``ms_deform_attn_encoder_pallas``, dispatch
``fused_ms_deform_attn``). It gathers, where the TPU kernel built one-hot
selection matmuls over halo windows, so it serves any queries.

Contract of both functions below (the JAX ``ms_deform_attn_core_jnp``'s):
value (B, sum HW, nH, hd) with the levels concatenated along axis 1;
spatial_shapes [(H_l, W_l)] per level; locations (B, Q, nH, L, P, 2)
normalized to [0, 1] (align_corners=False); weights (B, Q, nH, L, P).
Returns (B, Q, nH * hd) fp32. Corners outside the map contribute zero.

``ms_deform_attn`` is the wrapper the model calls: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel, and nothing falls back.
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
QUERIES_PER_BLOCK = 8       # consecutive queries share a block (L1 reuse)


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

    lib = load_library("msdeform_attn_fwd")
    lib.msdeform_attn_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.msdeform_attn_fwd.restype = ctypes.c_int
    lib.msdeform_attn_error_string.argtypes = [ctypes.c_int]
    lib.msdeform_attn_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(value, spatial_shapes, locations, weights):
    lib = _library()
    b, s, nh, hd = value.shape
    q, nl, p = locations.shape[1], len(spatial_shapes), locations.shape[4]
    hw = (ctypes.c_int * (2 * nl))(*[int(d) for hw_ in spatial_shapes
                                     for d in hw_])
    out = torch.empty((b, q, nh * hd), dtype=torch.float32,
                      device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msdeform_attn_fwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            locations.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, s, q, nh, hd, nl, p, hw, QUERIES_PER_BLOCK, stream)
    if err:
        msg = lib.msdeform_attn_error_string(err).decode()
        raise RuntimeError(f"msdeform_attn_fwd launch failed: {msg} ({err})")
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Sampling core the model calls (``MSDeformAttn.core_fn``).

    CUDA tensors launch the hand-written kernel (and count the launch in
    ``ms_deform_attn.launches``); CPU tensors take the plain version.
    """
    if value.device.type == "cpu":
        return ms_deform_attn_core_torch(value, spatial_shapes, locations,
                                         weights)
    if value.device.type != "cuda":
        raise RuntimeError(f"no sampling kernel for device {value.device}")
    _check_inputs(value, spatial_shapes, locations, weights)
    return _launch_cuda(value, spatial_shapes, locations, weights)


ms_deform_attn.launches = 0
