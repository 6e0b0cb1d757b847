"""Full self-attention of the full-attention encoder: the CUDA kernels K8
(forward) and K9 (backward) and their plain versions.

``softmax(q . k^T * scale) . v`` over (B, nH, S, hd), no mask, every query
against all S keys: what ``vision_instance_seg_tpu/models/pixel_decoder.py``
``_flash_or_dense_attention`` computes, with JAX's bundled TPU
flash-attention forward (``_flash_attention_impl``) on a TPU and a dense
jnp path elsewhere. K8 (``csrc/flash_attn_fwd.cu``) replaces the TPU
kernel: bf16 on the tensor cores (one pass of an online softmax over
64-key blocks), fp32 on a SIMT body of the same loop.

The backward replaces JAX's flash-attention backward
(``_flash_attention_bwd``: the TPU kernels ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``): P recomputed from q, k and each row's
log-sum-exp, which K8 writes when asked, and D = rowsum(o * dO). In bf16
one fused kernel (``csrc/flash_attn_bwd.cu``
``flash_attn_bwd``) gives dK and dV by key blocks and adds each key block's
partial of dQ into an fp32 accumulator, between two helper kernels (the
row statistics and the zeroed accumulator before it, dQ's scaled cast
after it); in fp32 D in torch, then two SIMT kernels that split the work
as JAX does, K9a (dK and dV by key blocks) and K9b (dQ by query blocks).

``full_attention`` is the entry point the encoder calls: a CPU tensor takes
the plain forward (differentiable by autograd); a CUDA tensor that requires
grad (with grad enabled) ``FlashAttentionFunction``, K8 with the row
log-sum-exp forward and D and K9 backward; any other CUDA tensor K8
alone. The kernels raise on what they do not take (a head dim that is not
a multiple of 16 or is above 128, a type other than bf16 or fp32, rows that
are not 16-byte aligned). Nothing falls back.
``LAUNCHES["flash_attn_fwd"]``, ``["flash_attn_bwd"]`` (bf16) and
``["flash_attn_bwd_dkv"]``, ``["flash_attn_bwd_dq"]`` (fp32) count the
launches.
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
                             # a multiple of this (K9's query block)
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


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/flash_attn_bwd.cu``'s entry points (a
    build of it, or of a version of it)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    for name, n_ptr in (("flash_attn_bwd", 10), ("flash_attn_bwd_dkv", 9),
                        ("flash_attn_bwd_dq", 8)):
        getattr(lib, name).argtypes = [p] * n_ptr + [i] * 4 + [ll, f, p]
    lib.flash_attn_bwd_prep.argtypes = ([p] * 3 + [ll] * 2 + [p] * 4 +
                                        [i] * 4 + [ll, p])
    lib.flash_attn_bwd_dq_cast.argtypes = [p] * 3 + [i] * 4 + [ll, f, p]
    lib.flash_attn_bwd_block_keys.argtypes = []
    lib.flash_attn_bwd_error_string.argtypes = [i]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    from vision_instance_seg_tpu_torch.kernels.build import load_library
    return _bind_bwd(load_library("flash_attn_bwd"))


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


def _bwd_operands(q, k, v, o, lse, do) -> tuple:
    """The cotangent and the forward's output with 16-byte aligned rows and
    its lse with contiguous tokens, after K9's checks."""
    if do.shape == q.shape and not _rows_aligned(do):
        do = do.contiguous()
    if o.shape == q.shape and not _rows_aligned(o):
        o = o.contiguous()
    _check_operands("K9", q, k, v, do, o)
    if lse.shape != q.shape[:3] or lse.device != q.device or \
            lse.dtype != torch.float32:
        raise ValueError(f"K9 takes an fp32 lse of (B, nH, S) on q's device: "
                         f"{tuple(lse.shape)} {lse.dtype}")
    return do, o, lse if lse.stride(-1) == 1 else lse.contiguous()


def _strides(*ts: torch.Tensor):
    """The C interface's 21 element strides: (batch, head, token) of q, k,
    v, the cotangent, dq, dk, dv, in that order."""
    return (ctypes.c_longlong * 21)(*(st for t in ts for st in t.stride()[:3]))


def _call(name: str, *args, lib=None) -> None:
    lib = lib or _bwd_library()
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_attn_bwd_error_string(err).decode()}"
                           f" ({err})")
    if name in LAUNCH_NAMES:
        LAUNCHES[name] += 1


# the kernels counted in LAUNCHES: K9 (bf16) and K9a, K9b (fp32), not the
# bf16 kernel's two helpers (flash_attn_bwd_prep, flash_attn_bwd_dq_cast)
LAUNCH_NAMES = ("flash_attn_bwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_prep(q, o, lse, do, lib=None) -> tuple:
    """bf16, before the fused kernel (``flash_attn_bwd_prep``): the row
    statistics (2, B nH, stat_row) fp32, lse * log2 e and D = rowsum(o *
    do), zero past S, and the zeroed dQ accumulator (B nH, stat_row, hd)
    fp32."""
    b, nh, s, hd = q.shape
    sp = _stat_row(s)
    stats = torch.empty((2, b * nh, sp), dtype=torch.float32,
                        device=q.device)
    acc = torch.empty((b * nh, sp, hd), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_attn_bwd_prep", o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), lse.stride(0), lse.stride(1),
              stats[0].data_ptr(), stats[1].data_ptr(), acc.data_ptr(),
              _strides(o, o, o, do, o, o, o), b, nh, s, hd, sp, _stream(q),
              lib=lib)
    return stats, acc


def _launch_bwd_kernel(q, k, v, do, stats, dq_acc, dk, dv, scale: float,
                       lib=None) -> None:
    """The fused bf16 K9 (``flash_attn_bwd``) on operands from
    ``_bwd_operands`` and ``_bwd_prep``: dk and dv (B, nH, S, hd) with
    16-byte aligned rows, dQ / scale added into ``dq_acc``."""
    b, nh, s, hd = q.shape
    with torch.cuda.device(q.device):
        _call("flash_attn_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
              dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              _strides(q, k, v, do, q, dk, dv), b, nh, s, hd,
              stats.shape[-1], scale, _stream(q), lib=lib)


def _bwd_dq_cast(acc, dq, scale: float, lib=None) -> None:
    """bf16, after the fused kernel (``flash_attn_bwd_dq_cast``): dq =
    accumulator * scale, cast."""
    b, nh, s, hd = dq.shape
    with torch.cuda.device(dq.device):
        _call("flash_attn_bwd_dq_cast", acc.data_ptr(), dq.data_ptr(),
              _strides(dq, dq, dq, dq, dq, dq, dq), b, nh, s, hd,
              acc.shape[1], scale, _stream(dq), lib=lib)


def _launch_bwd_simt(q, k, v, o, lse, do, dq, dk, dv, scale: float) -> None:
    """fp32: D and the statistics in torch ((2, B, nH, stat_row), zero past
    S), then K9a (``flash_attn_bwd_dkv``: dk, dv) and K9b
    (``flash_attn_bwd_dq``: dq)."""
    b, nh, s, hd = q.shape
    stats = torch.zeros((2, b, nh, _stat_row(s)), dtype=torch.float32,
                        device=q.device)
    stats[0, ..., :s] = lse
    stats[1, ..., :s] = (o * do).sum(-1)
    strides = _strides(q, k, v, do, dq, dk, dv)
    ptrs = [t.data_ptr() for t in (q, k, v, do, stats[0], stats[1])]
    with torch.cuda.device(q.device):
        tail = (strides, b, nh, s, hd, stats.shape[-1], scale, _stream(q))
        _call("flash_attn_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
              *tail)
        _call("flash_attn_bwd_dq", *ptrs, dq.data_ptr(), *tail)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                scale: float, lib=None) -> tuple:
    """K9 on CUDA tensors: in bf16 the fused kernel between its two helpers
    (the statistics and the zeroed fp32 dQ accumulator before it, dQ's
    scaled cast after it); in fp32 D in torch, then K9a and K9b. The
    gradients are (B, nH, S, hd) views of (B, S, nH, hd) memory. ``lib``:
    another build of the kernels' source (the bf16 benches' variants)."""
    do, o, lse = _bwd_operands(q, k, v, o, lse, do)
    dq, dk, dv = _heads_view(q), _heads_view(k), _heads_view(v)
    with torch.autocast(q.device.type, enabled=False):
        if q.dtype != torch.bfloat16:
            _launch_bwd_simt(q, k, v, o, lse, do, dq, dk, dv, scale)
            return dq, dk, dv
        stats, acc = _bwd_prep(q, o, lse, do, lib)
        _launch_bwd_kernel(q, k, v, do, stats, acc, dk, dv, scale, lib)
        _bwd_dq_cast(acc, dq, scale, lib)
    return dq, dk, dv


def _forward_lse(q, k, v, scale):
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, with_lse=True)
    return full_attention_torch(q, k, v, scale), attention_lse_torch(q, k,
                                                                     scale)


class FlashAttentionFunction(torch.autograd.Function):
    """K8 with each row's log-sum-exp forward; D and K9 backward, on
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
    """(B, nH, S, hd) self-attention: for CUDA tensors K8, with K9
    behind it when a gradient is wanted; the plain version for CPU tensors.
    The output is (B, nH, S, hd); the kernels' is a view of (B, S, nH, hd)
    memory."""
    if q.device.type != "cuda":
        return full_attention_torch(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return _launch(q, k, v, scale)
