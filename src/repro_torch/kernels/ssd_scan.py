"""Mamba2 SSD scan on Hopper: wrapper of ``ssd_scan_kernel``.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan``, scalar decay per
head:

    h <- h exp(dA_t) + xdt_t^T B_t,   y_t = h C_t

with an initial state ``h0`` and any sequence length.  On a CUDA tensor it
launches the CUDA kernel in ``csrc/scan.cu`` (chunks of 64 steps on the
tensor cores, a ragged last chunk zero-padded); on a CPU tensor it runs
the plain ``ref.ssd_ref``.  There is no other path, and no backward:
under grad mode an input that requires grad is refused (the
differentiable entry is ``repro_torch.models.ssm.ssd``).

B and C are read through their strides, so the Mamba2 block passes its
group-form (B, S, N) tensors as ``Bm[:, :, None].expand(B, S, H, N)``: a
head stride of 0 and no copy.

The launch goes through the custom op ``torch.ops.repro.ssd_scan`` (a
fake implementation for ``FakeTensorMode`` and meta tensors;
``sharding_rule`` and ``flops`` for ``kernels.ops.register_mesh_rules``).

``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES


def _validate(xdt, Bm, Cm, dA, h0):
    if xdt.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError("ssd_scan: xdt (B,S,H,hd), Bm/Cm (B,S,H,N)")
    B, S, H, hd = xdt.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape[:3]) != (B, S, H) or tuple(dA.shape) != (B, S, H):
        raise ValueError(f"ssd_scan: shapes {tuple(xdt.shape)} {tuple(Bm.shape)} "
                         f"{tuple(dA.shape)} disagree")
    if h0 is not None and tuple(h0.shape) != (B, H, hd, N):
        raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)} is not {(B, H, hd, N)}")
    tensors = (xdt, Bm, Cm, dA) + (() if h0 is None else (h0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan: tensors on different devices")
    if not (xdt.dtype == Bm.dtype == Cm.dtype):
        raise ValueError("ssd_scan: xdt, Bm, Cm of different dtypes")
    if S < 1:
        raise ValueError("ssd_scan: empty sequence")


def ssd_scan(xdt, Bm, Cm, dA, *, h0=None):
    """xdt: (B, S, H, hd) = x * dt; Bm, Cm: (B, S, H, N); dA: (B, S, H) <= 0
    float32; h0: (B, H, hd, N) float32 or None (zeros).  Returns (y (B, S,
    H, hd) in xdt's dtype, final state (B, H, hd, N) float32)."""
    _validate(xdt, Bm, Cm, dA, h0)
    _build.refuse_grad("ssd_scan", "repro_torch.models.ssm.ssd", xdt, Bm, Cm, dA, h0)
    _build.check_device("ssd_scan", xdt)
    return _ssd_op(xdt, Bm, Cm, dA, h0)


@torch.library.custom_op("repro::ssd_scan", mutates_args=())
def _ssd_op(xdt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dA: torch.Tensor,
            h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if xdt.device.type == "cpu":
        y, h_fin = ref.ssd_ref(xdt, Bm, Cm, dA, h0)
        return y.to(xdt.dtype).contiguous(), h_fin.contiguous()
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xdt.device}")
    B, S, H, hd = xdt.shape
    N = Bm.shape[-1]
    if xdt.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: dtype {xdt.dtype} not in {list(DTYPES)}")
    if dA.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dA must be float32, not {dA.dtype}")
    if any(t.stride(3) != 1 for t in (xdt, Bm, Cm)):
        raise ValueError("ssd_scan: the last dimension must be contiguous")
    for t in (xdt, Bm, Cm):
        _build.check_vector_aligned("ssd_scan", t, (0, 1, 2))
    if h0 is not None and (h0.dtype != torch.float32 or not h0.is_contiguous()):
        raise ValueError("ssd_scan: h0 must be contiguous float32")
    lib = _build.load()
    y = torch.empty((B, S, H, hd), dtype=xdt.dtype, device=xdt.device)
    h_fin = torch.empty((B, H, hd, N), dtype=torch.float32, device=xdt.device)
    strides = _build.strides_arg(*((t, (0, 1, 2)) for t in (xdt, Bm, Cm, dA)))
    with torch.cuda.device(xdt.device):
        err = lib.repro_ssd_scan(
            DTYPES[xdt.dtype], hd, N, xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dA.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_fin.data_ptr(), B, S, H, strides,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_fin


@_ssd_op.register_fake
def _(xdt, Bm, Cm, dA, h0):
    B, S, H, hd = xdt.shape
    N = Bm.shape[-1]
    return xdt.new_empty((B, S, H, hd)), xdt.new_empty((B, H, hd, N), dtype=torch.float32)


def flops(xdt_shape, Bm_shape, *args, out_shape=None, **kwargs):
    """The read-out C·S and the rank-1 update xdtᵀB per step and head, 2
    flops per FMA: the count that ``chip_smoke.py``'s kernel table bounds
    the kernel by."""
    B, S, H, hd = xdt_shape
    return B * S * H * 4 * hd * Bm_shape[-1]


def sharding_rule(xdt, Bm, Cm, dA, h0):
    """Batch or heads may shard; the sequence and the state dimensions may
    not."""
    from torch.distributed.tensor import Replicate, Shard
    R, hs = Replicate(), None if h0 is None else Replicate()
    b, h = Shard(0), Shard(2)
    return [([R, R], [R, R, R, R, hs]),
            ([b, b], [b, b, b, b, None if h0 is None else b]),
            ([h, Shard(1)], [h, h, h, h, None if h0 is None else Shard(1)])]


ssd_scan.launches = 0
