"""What the plain references share: float32 norms and the products, in the
precision asked for.

``Precision("float32")`` multiplies in float32 with TF32 off.
``Precision("tf32")`` is the control's precision: on a card the products
run on the TF32 tensor cores; on the CPU, which has none, each operand is
rounded to TF32's 10 mantissa bits first, as the tensor cores read it.
Imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @contextlib.contextmanager
    def active(self, device):
        """TF32 switched on a card for the control, off otherwise."""
        on = self.name == "tf32" and torch.device(device).type == "cuda"
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _operand(self, x):
        if self.name == "tf32" and x.device.type == "cpu":
            return round_tf32(x.float())
        return x.float()

    def mm(self, a, b):
        return self._operand(a) @ self._operand(b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self._operand(x) for x in xs))


def rms_norm(x, scale, eps):
    """RMSNorm with a zero-centred scale: x / rms(x) * (1 + scale)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias
