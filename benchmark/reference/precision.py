"""The control of the correctness check: the reference computed one step
below the configuration's bfloat16, with the operands of every matrix
product and convolution rounded to fp8 (e4m3, one scale per tensor, as an
fp8 path would hand them to the tensor cores). Gradients pass the
rounding unchanged."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0

PRODUCTS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.__matmul__,
            torch.bmm, torch.einsum}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


class Fp8Operands(TorchFunctionMode):
    """Within it, every product's tensor operands are rounded to fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            if func is torch.einsum:
                args = (args[0],) + tuple(round_fp8(a) for a in args[1:])
            else:           # the two operands; a bias stays as it is
                args = tuple(round_fp8(a) for a in args[:2]) + args[2:]
        return func(*args, **kwargs)
