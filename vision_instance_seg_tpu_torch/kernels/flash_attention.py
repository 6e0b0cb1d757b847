"""Full self-attention of the full-attention encoder: the CUDA kernels K8
(forward), K9a and K9b (backward) and their plain versions.

``softmax(q . k^T * scale) . v`` over (B, nH, S, hd), no mask, every query
against all S keys: what ``vision_instance_seg_tpu/models/pixel_decoder.py``
``_flash_or_dense_attention`` computes, with JAX's bundled TPU
flash-attention forward (``_flash_attention_impl``) on a TPU and a dense
jnp path elsewhere. K8 (``csrc/flash_attn_fwd.cu``) replaces the TPU
kernel: bf16 on the tensor cores (one pass of an online softmax over
64-key blocks), fp32 on a SIMT body of the same loop.

The backward is JAX's flash-attention backward, split as JAX splits it
(``_flash_attention_bwd``: ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``, the TPU kernels that K9a and K9b of
``csrc/flash_attn_bwd.cu`` replace): P recomputed from q, k and each row's
log-sum-exp, which K8 writes when asked; D = rowsum(o * dO) in torch
before both kernels; K9a gives dK and dV by key blocks, K9b dQ by query
blocks.

``full_attention`` is the entry point the encoder calls: a CPU tensor takes
the plain forward (differentiable by autograd); a CUDA tensor that requires
grad (with grad enabled) ``FlashAttentionFunction``, K8 with the row
log-sum-exp forward and D, K9a and K9b backward; any other CUDA tensor K8
alone. The kernels raise on what they do not take (a head dim that is not
a multiple of 16 or is above 128, a type other than bf16 or fp32, rows that
are not 16-byte aligned). Nothing falls back.
``LAUNCHES["flash_attn_fwd"]``, ``["flash_attn_bwd_dkv"]`` and
``["flash_attn_bwd_dq"]`` count the launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

MAX_HEAD_DIM = 128           # csrc: head dims 16, 32, ..., 128
MAX_HEADS_TIMES_BATCH = 65535    # the grid's second dimension
MAX_CHUNK_BYTES = 2 ** 31    # the plain version's fp32 logits per chunk
STAT_BLOCK = 64              # csrc: the row statistics' rows are padded to
                             # a multiple of this (K9a's query block)
LAUNCHES: collections.Counter = collections.Counter()


def _chunk_rows(q: torch.Tensor, max_chunk_bytes: int) -> int:
    """Query rows a chunk whose (B, nH, rows, S) fp32 tensor stays under
    ``max_chunk_bytes``."""
    b, nh, s, _ = q.shape
    return max(1, max_chunk_bytes // (4 * b * nh * s))


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
    s = q.shape[2]
    rows = _chunk_rows(q, max_chunk_bytes)
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


def attention_lse_torch(q: torch.Tensor, k: torch.Tensor, scale: float,
                        max_chunk_bytes: int = MAX_CHUNK_BYTES
                        ) -> torch.Tensor:
    """Plain row statistic of K8: (B, nH, S) fp32 log-sum-exp (natural log)
    of each row of the fp32 logits q . k^T * scale, query rows in chunks as
    ``full_attention_torch`` takes them."""
    rows = _chunk_rows(q, max_chunk_bytes)
    kt = k.float().transpose(-1, -2)
    with torch.autocast(q.device.type, enabled=False):
        out = [torch.logsumexp(torch.matmul(q[:, :, r:r + rows].float(), kt)
                               * scale, -1)
               for r in range(0, q.shape[2], rows)]
    return torch.cat(out, 2)


def flash_attention_bwd_dq_torch(q, k, v, o, lse, do, scale: float,
                                 max_chunk_bytes: int = MAX_CHUNK_BYTES
                                 ) -> torch.Tensor:
    """Plain K9b: dq by chunks of query rows (``flash_attention_bwd_torch``
    says how)."""
    rows = _chunk_rows(q, max_chunk_bytes)
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
        lf = lse.float()
        delta = (o.float() * gf).sum(-1)
        dq = []
        for r in range(0, q.shape[2], rows):
            p = torch.exp(torch.matmul(qf[:, :, r:r + rows], kf.transpose(
                -1, -2)) * scale - lf[:, :, r:r + rows, None])
            dp = torch.matmul(gf[:, :, r:r + rows], vf.transpose(-1, -2))
            ds = p * (dp - delta[:, :, r:r + rows, None])
            del p, dp
            dq.append(torch.matmul(ds, kf) * scale)
            del ds
    return torch.cat(dq, 2).to(q.dtype)


def flash_attention_bwd_dkv_torch(q, k, v, o, lse, do, scale: float,
                                  max_chunk_bytes: int = MAX_CHUNK_BYTES
                                  ) -> tuple:
    """Plain K9a: (dk, dv) by chunks of key rows, P^T recomputed
    (``flash_attention_bwd_torch`` says how)."""
    rows = _chunk_rows(q, max_chunk_bytes)
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
        lf = lse.float()
        delta = (o.float() * gf).sum(-1)
        dk, dv = [], []
        for c in range(0, q.shape[2], rows):
            pt = torch.exp(torch.matmul(kf[:, :, c:c + rows], qf.transpose(
                -1, -2)) * scale - lf[:, :, None, :])
            dv.append(torch.matmul(pt, gf))
            dpt = torch.matmul(vf[:, :, c:c + rows], gf.transpose(-1, -2))
            dst = pt * (dpt - delta[:, :, None, :])
            del pt, dpt
            dk.append(torch.matmul(dst, qf) * scale)
            del dst
    return torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype)


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              scale: float,
                              max_chunk_bytes: int = MAX_CHUNK_BYTES
                              ) -> tuple:
    """Plain K9a and K9b: (dq, dk, dv) of softmax(q . k^T * scale) . v for
    the cotangent ``do``, from the forward's output ``o`` and row
    log-sum-exp ``lse`` ((B, nH, S), natural log). JAX's
    ``mha_reference_bwd`` rounding for rounding: the operands cast to
    fp32, P = exp(q . k^T * scale - lse), dP = dO . v^T, D = rowsum(o *
    dO), dS = P (dP - D), dV = P^T dO, dK = dS^T q * scale, dQ = dS k *
    scale, all in fp32, each gradient cast once to its operand's dtype. As
    the kernels split it: dQ by chunks of query rows, dK and dV by chunks
    of key rows (P^T recomputed), each chunk's fp32 S x rows tensors under
    ``max_chunk_bytes``. Every gradient row is one product over all S
    rows of the other side, so the chunks change nothing."""
    dq = flash_attention_bwd_dq_torch(q, k, v, o, lse, do, scale,
                                      max_chunk_bytes)
    return (dq, *flash_attention_bwd_dkv_torch(q, k, v, o, lse, do, scale,
                                               max_chunk_bytes))


def takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether K8 takes operands of this dtype and head dim."""
    return (dtype in (torch.bfloat16, torch.float32) and head_dim % 16 == 0
            and 16 <= head_dim <= MAX_HEAD_DIM)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library
    lib = load_library("flash_attn_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = ([p] * 5 + [i] * 5 +
                                   [ctypes.c_float, p, ctypes.c_longlong, p])
    lib.flash_attn_fwd.restype = ctypes.c_int
    lib.flash_attn_fwd_error_string.argtypes = [i]
    lib.flash_attn_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library
    lib = load_library("flash_attn_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attn_bwd_dkv.argtypes = ([p] * 9 + [i] * 4 +
                                       [ll, i, ctypes.c_float, p])
    lib.flash_attn_bwd_dq.argtypes = ([p] * 8 + [i] * 4 +
                                      [ll, i, ctypes.c_float, p])
    lib.flash_attn_bwd_dkv.restype = lib.flash_attn_bwd_dq.restype = i
    lib.flash_attn_bwd_error_string.argtypes = [i]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _rows_aligned(t: torch.Tensor) -> bool:
    """The head dim contiguous and every row 16-byte aligned, as K8's
    16-byte copies need (any strides of batch, head and token)."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:3]))


def _check_operands(what: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what} takes operands of one (B, nH, S, hd) "
                         f"shape: {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype or t.device != q.device for t in ts):
        raise ValueError(f"{what} takes operands of one dtype on one device")
    b, nh, _, hd = q.shape
    if not takes(q.dtype, hd):
        raise ValueError(f"{what} takes bf16 or fp32 with a head dim that is "
                         f"a multiple of 16 up to {MAX_HEAD_DIM}: {q.dtype}, "
                         f"head dim {hd}")
    if b * nh > MAX_HEADS_TIMES_BATCH:
        raise ValueError(f"{what} takes at most {MAX_HEADS_TIMES_BATCH} "
                         f"batch x heads: {b} x {nh}")
    if not all(_rows_aligned(t) for t in ts):
        raise ValueError(f"{what} copies 16 bytes at a time: its operands "
                         f"need a contiguous head dim and 16-byte aligned "
                         f"rows")


def _stat_row(s: int) -> int:
    return -(-s // STAT_BLOCK) * STAT_BLOCK


def _heads_view(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, nH, S, hd) tensor over (B, S, nH, hd) memory, the
    encoder's layout on both sides of the attention."""
    b, nh, s, hd = like.shape
    return torch.empty((b, s, nh, hd), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, with_lse: bool = False):
    """K8: the output, and with ``with_lse`` also each row's log-sum-exp,
    (B, nH, S) fp32, a view of rows padded to a multiple of
    ``STAT_BLOCK``."""
    _check_operands("K8", q, k, v)
    b, nh, s, hd = q.shape
    out = _heads_view(q)
    lse = (torch.empty((b, nh, _stat_row(s)), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, nh, s, hd, int(q.dtype == torch.bfloat16), scale,
            None if lse is None else lse.data_ptr(),
            0 if lse is None else lse.shape[-1], stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: "
                           f"{lib.flash_attn_fwd_error_string(err).decode()}"
                           f" ({err})")
    LAUNCHES["flash_attn_fwd"] += 1
    return out if lse is None else (out, lse[..., :s])


def _padded_stat(t: torch.Tensor) -> torch.Tensor:
    """A (B, nH, S) fp32 row statistic as the kernels read it: rows of
    ``_stat_row(S)`` floats (the view K8 returns already is one)."""
    b, nh, s = t.shape
    sp = _stat_row(s)
    if t.dtype == torch.float32 and t.stride() == (nh * sp, sp, 1) and \
            t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((b, nh, sp), dtype=torch.float32, device=t.device)
    out[..., :s] = t
    return out


def _bwd_operands(q, k, v, o, lse, do) -> tuple:
    """The cotangent with 16-byte aligned rows, each row's lse and D =
    rowsum(o * do) (fp32, torch) in rows of ``_stat_row(S)`` floats, after
    K9's checks."""
    if do.shape == q.shape and not _rows_aligned(do):
        do = do.contiguous()
    _check_operands("K9", q, k, v, do)
    if o.shape != q.shape or lse.shape != q.shape[:3] or \
            o.device != q.device or lse.device != q.device:
        raise ValueError(f"K9 takes o of q's shape and lse of (B, nH, S) on "
                         f"q's device: {tuple(o.shape)}, {tuple(lse.shape)}")
    with torch.autocast(q.device.type, enabled=False):
        delta = (o.float() * do.float()).sum(-1)
    return do, _padded_stat(lse), _padded_stat(delta)


def _launch_bwd_kernel(name: str, q, k, v, do, lse, delta, outs,
                       scale: float) -> None:
    """K9a (``flash_attn_bwd_dkv``: outs dk, dv) or K9b
    (``flash_attn_bwd_dq``: outs dq) on operands from ``_bwd_operands``;
    outs are (B, nH, S, hd) with 16-byte aligned rows."""
    b, nh, s, hd = q.shape
    # the strides of dq, dk, dv; each kernel reads only its own (q fills
    # the others)
    grads = (q, *outs) if name == "flash_attn_bwd_dkv" else (outs[0], q, q)
    strides = (ctypes.c_longlong * 21)(
        *(st for t in (q, k, v, do, *grads) for st in t.stride()[:3]))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            strides, b, nh, s, hd, _stat_row(s),
            int(q.dtype == torch.bfloat16), scale, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_attn_bwd_error_string(err).decode()}"
                           f" ({err})")
    LAUNCHES[name] += 1


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                scale: float) -> tuple:
    """D in torch, then K9a (dk, dv) and K9b (dq). The gradients are (B,
    nH, S, hd) views of (B, S, nH, hd) memory."""
    do, lse, delta = _bwd_operands(q, k, v, o, lse, do)
    dq, dk, dv = _heads_view(q), _heads_view(k), _heads_view(v)
    _launch_bwd_kernel("flash_attn_bwd_dkv", q, k, v, do, lse, delta,
                       (dk, dv), scale)
    _launch_bwd_kernel("flash_attn_bwd_dq", q, k, v, do, lse, delta, (dq,),
                       scale)
    return dq, dk, dv


def _forward_lse(q, k, v, scale):
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, with_lse=True)
    return full_attention_torch(q, k, v, scale), attention_lse_torch(q, k,
                                                                     scale)


class FlashAttentionFunction(torch.autograd.Function):
    """K8 with each row's log-sum-exp forward; D, K9a and K9b backward, on
    CUDA. On the CPU the plain versions of the same steps
    (``full_attention_torch`` and ``attention_lse_torch``, then
    ``flash_attention_bwd_torch``), which the CPU tests use to check this
    wiring. The cotangent is cast to the operands' dtype first, as JAX's
    custom_vjp receives it."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale):
        out, lse = _forward_lse(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if q.device.type == "cuda":
            dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_torch(q, k, v, o, lse, do,
                                                   ctx.scale)
        return dq, dk, dv, None


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """(B, nH, S, hd) self-attention: for CUDA tensors K8, with K9a and K9b
    behind it when a gradient is wanted; the plain version for CPU tensors.
    The output is (B, nH, S, hd); the kernels' is a view of (B, S, nH, hd)
    memory."""
    if q.device.type != "cuda":
        return full_attention_torch(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return _launch(q, k, v, scale)
