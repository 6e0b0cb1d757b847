"""Full self-attention of the full-attention encoder: the CUDA kernel K8
and its plain version.

``softmax(q . k^T * scale) . v`` over (B, nH, S, hd), no mask, every query
against all S keys: what ``vision_instance_seg_tpu/models/pixel_decoder.py``
``_flash_or_dense_attention`` computes, with JAX's bundled TPU
flash-attention forward (``_flash_attention_impl``) on a TPU and a dense
jnp path elsewhere. K8 (``csrc/flash_attn_fwd.cu``) replaces the TPU
kernel: bf16 on the tensor cores (one pass of an online softmax over
64-key blocks), fp32 on a SIMT body of the same loop.

``full_attention`` is the entry point the encoder calls: a CPU tensor takes
the plain version, a CUDA tensor K8, which raises on what it does not take
(a head dim that is not a multiple of 16 or is above 128, a type other than
bf16 or fp32, rows that are not 16-byte aligned). Nothing falls back. K8
has no backward yet: on CUDA, an input that requires grad while grad is
enabled raises NotImplementedError.
``LAUNCHES["flash_attn_fwd"]`` counts its launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

MAX_HEAD_DIM = 128           # csrc: head dims 16, 32, ..., 128
MAX_HEADS_TIMES_BATCH = 65535    # the grid's second dimension
MAX_CHUNK_BYTES = 2 ** 31    # the plain version's fp32 logits per chunk
LAUNCHES: collections.Counter = collections.Counter()


def full_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float,
                         max_chunk_bytes: int = MAX_CHUNK_BYTES
                         ) -> torch.Tensor:
    """Plain K8, the JAX dense path rounding for rounding: q * scale in q's
    dtype (the scale rounded to it first, as JAX's weak-typed scalar is),
    fp32 logits and softmax, p cast to v's dtype, the second product
    accumulated in fp32 and cast to v's dtype. Query rows go in chunks
    whose fp32 logits stay under ``max_chunk_bytes``; each row's softmax is
    its own, so the chunks change nothing."""
    b, nh, s, _ = q.shape
    rows = max(1, max_chunk_bytes // (4 * b * nh * s))
    with torch.autocast(q.device.type, enabled=False):
        qs = q * float(torch.tensor(scale, dtype=q.dtype))
        kt = k.float().transpose(-1, -2)
        vf = v.float()
        outs = []
        for r in range(0, s, rows):
            logits = torch.matmul(qs[:, :, r:r + rows].float(), kt)
            p = logits.softmax(-1).to(v.dtype)
            del logits
            outs.append(torch.matmul(p.float(), vf).to(v.dtype))
            del p
    return torch.cat(outs, 2) if len(outs) > 1 else outs[0]


def takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether K8 takes operands of this dtype and head dim."""
    return (dtype in (torch.bfloat16, torch.float32) and head_dim % 16 == 0
            and 16 <= head_dim <= MAX_HEAD_DIM)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library
    lib = load_library("flash_attn_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = ([p] * 5 + [i] * 5 + [ctypes.c_float, p])
    lib.flash_attn_fwd.restype = ctypes.c_int
    lib.flash_attn_fwd_error_string.argtypes = [i]
    lib.flash_attn_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _rows_aligned(t: torch.Tensor) -> bool:
    """The head dim contiguous and every row 16-byte aligned, as K8's
    16-byte copies need (any strides of batch, head and token)."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:3]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"K8 takes q, k, v of one (B, nH, S, hd) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            not (q.device == k.device == v.device):
        raise ValueError("K8 takes q, k, v of one dtype on one device")
    b, nh, s, hd = q.shape
    if not takes(q.dtype, hd):
        raise ValueError(f"K8 takes bf16 or fp32 with a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}: {q.dtype}, "
                         f"head dim {hd}")
    if b * nh > MAX_HEADS_TIMES_BATCH:
        raise ValueError(f"K8 takes at most {MAX_HEADS_TIMES_BATCH} "
                         f"batch x heads: {b} x {nh}")
    if not all(_rows_aligned(t) for t in (q, k, v)):
        raise ValueError("K8 copies 16 bytes at a time: q, k and v need a "
                         "contiguous head dim and 16-byte aligned rows")
    # (B, S, nH, hd) memory: the encoder's layout for its output projection
    out = torch.empty((b, s, nh, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, nh, s, hd, int(q.dtype == torch.bfloat16), scale,
            stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: "
                           f"{lib.flash_attn_fwd_error_string(err).decode()}"
                           f" ({err})")
    LAUNCHES["flash_attn_fwd"] += 1
    return out


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """(B, nH, S, hd) self-attention: K8 for CUDA tensors, the plain version
    for CPU tensors. The output is (B, nH, S, hd); K8's is a view of (B, S,
    nH, hd) memory."""
    if q.device.type != "cuda":
        return full_attention_torch(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "K8 (the flash-attention forward) has no backward yet: the "
            "flash backward, K9 (dK/dV and dQ), is the next slice of the "
            "port")
    return _launch(q, k, v, scale)
