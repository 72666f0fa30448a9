"""RWKV6 WKV scan on Hopper: wrapper of ``rwkv6_scan_kernel``.

Replaces the Pallas TPU kernel ``repro.kernels.rwkv6_scan``:

    y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(logw_t)) S + k_t^T v_t

with an initial state ``s0`` and any sequence length.  On a CUDA tensor it
launches the CUDA kernel in ``csrc/scan.cu`` (chunks of 32 steps, a ragged
last chunk zero-padded); on a CPU tensor it runs the plain
``ref.rwkv6_ref``.  There is no other path, and no backward: under grad
mode an input that requires grad is refused (the differentiable entry is
``repro_torch.models.rwkv.wkv``).  ``logw`` must already be clamped to
``>= LOGW_CLAMP = -2`` (``models/rwkv.py`` does), as for the TPU kernel:
the chunked factorisation takes exponents up to 64 at that floor.

The launch goes through the custom op ``torch.ops.repro.rwkv6_scan``
(a fake implementation for ``FakeTensorMode`` and meta tensors;
``sharding_rule`` and ``flops`` for ``kernels.ops.register_mesh_rules``).

``rwkv6_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES


def _validate(r, k, v, logw, u, s0):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError("rwkv6_scan: r, k, v, logw must share one (B,S,H,hd) shape")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} is not (H, hd) = {(H, hd)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"rwkv6_scan: s0 {tuple(s0.shape)} is not {(B, H, hd, hd)}")
    tensors = (r, k, v, logw, u) + (() if s0 is None else (s0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("rwkv6_scan: tensors on different devices")
    if len({t.dtype for t in (r, k, v, logw, u)}) != 1:
        raise ValueError("rwkv6_scan: r, k, v, logw, u of different dtypes")
    if S < 1:
        raise ValueError("rwkv6_scan: empty sequence")


def rwkv6_scan(r, k, v, logw, u, *, s0=None):
    """r, k, v, logw: (B, S, H, hd); u: (H, hd); s0: (B, H, hd, hd) float32
    or None (zeros).  Returns (y (B, S, H, hd) in r's dtype, final state
    (B, H, hd, hd) float32)."""
    _validate(r, k, v, logw, u, s0)
    _build.refuse_grad("rwkv6_scan", "repro_torch.models.rwkv.wkv", r, k, v, logw, u, s0)
    _build.check_device("rwkv6_scan", r)
    return _rwkv6_op(r, k, v, logw, u, s0)


@torch.library.custom_op("repro::rwkv6_scan", mutates_args=())
def _rwkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor, s0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if r.device.type == "cpu":
        y, s_fin = ref.rwkv6_ref(r, k, v, logw, u, s0)
        return y.to(r.dtype).contiguous(), s_fin.contiguous()
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    B, S, H, hd = r.shape
    if r.dtype not in DTYPES:
        raise TypeError(f"rwkv6_scan: dtype {r.dtype} not in {list(DTYPES)}")
    if any(t.stride(3) != 1 for t in (r, k, v, logw)):
        raise ValueError("rwkv6_scan: the head dimension must be contiguous")
    for t in (r, k, v, logw):
        _build.check_vector_aligned("rwkv6_scan", t, (0, 1, 2))
    if s0 is not None and (s0.dtype != torch.float32 or not s0.is_contiguous()):
        raise ValueError("rwkv6_scan: s0 must be contiguous float32")
    u = u.contiguous()
    lib = _build.load()
    y = torch.empty((B, S, H, hd), dtype=r.dtype, device=r.device)
    s_fin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    strides = _build.strides_arg(*((t, (0, 1, 2)) for t in (r, k, v, logw)))
    with torch.cuda.device(r.device):
        err = lib.repro_rwkv6_scan(
            DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), B, S, H, strides,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, s_fin


@_rwkv6_op.register_fake
def _(r, k, v, logw, u, s0):
    B, S, H, hd = r.shape
    return r.new_empty((B, S, H, hd)), r.new_empty((B, H, hd, hd), dtype=torch.float32)


def flops(r_shape, *args, out_shape=None, **kwargs):
    """The state's read-out r·S and its rank-1 update kᵀv per step and
    head, 2 flops per FMA (a chunked form decays the state once a chunk, so
    the per-step decay is left out): the count that ``chip_smoke.py``'s
    kernel table bounds the kernel by."""
    B, S, H, hd = r_shape
    return B * S * H * 4 * hd * hd


def sharding_rule(r, k, v, logw, u, s0):
    """Batch or heads may shard; the sequence and the head dimension may not."""
    from torch.distributed.tensor import Replicate, Shard
    R, s = Replicate(), None if s0 is None else Replicate()
    out = [([R, R], [R, R, R, R, R, s])]
    b, h = Shard(0), Shard(2)
    out.append(([b, b], [b, b, b, b, R, None if s0 is None else b]))
    out.append(([h, Shard(1)], [h, h, h, h, Shard(0), None if s0 is None else Shard(1)]))
    return out


rwkv6_scan.launches = 0
