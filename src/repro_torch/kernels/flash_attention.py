"""Flash attention (prefill) on Hopper: wrapper of ``flash_attn_kernel``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention`` (same
layout and masks: q (B,S,H,hd), k/v (B,S,KV,hd), GQA, causal and/or a
sliding window, finite NEG_INF).  Unlike the Pallas kernel, a call
without a mask may take k/v of a kv length of their own, (B,Skv,KV,hd):
a prompt's cross-attention to an encoder's frames; and v may be narrower
than q and k, (B,Skv,KV,hdv): multi-head latent attention (DeepSeek-V2)
scores over hd = 192 and averages values of hdv = 128, the one such pair
the kernel is built for.  On a CUDA tensor it
launches the CUDA kernel in ``csrc/attention.cu``; on a CPU tensor it
runs the plain ``ref.attention_ref``.  There is no other path, and no
backward: under grad mode an input that requires grad is refused (the
differentiable entry is ``repro_torch.models.attention.flash_attention``).

The launch goes through the custom op ``torch.ops.repro.flash_attention``:
its fake implementation gives the output's shape to ``FakeTensorMode`` and
meta tensors (the dry run), and ``sharding_rule`` / ``flops`` are the
DTensor sharding rule and the flop formula ``kernels.ops.register_mesh_rules``
registers.

``flash_attention.launches`` counts kernel launches, and
``mla_widths.launches`` those of them at q.k width 192 and v width 128.
"""
from __future__ import annotations

import math
import types
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k, v, causal, window):
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B,S,H,hd), k/v (B,Skv,KV,hd)")
    B, S, H, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd or k.shape[1] < 1:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} disagree")
    if k.shape[1] != S and (causal or window is not None):
        raise ValueError(f"flash_attention: kv length {k.shape[1]} != {S} needs "
                         "causal=False and no window")
    if H % k.shape[2]:
        raise ValueError("flash_attention: n_heads must be a multiple of n_kv_heads")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v of different dtypes")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q, k: (B, S, H, hd), (B, Skv, KV, hd); v: (B, Skv, KV, hdv) -> (B,
    S, H, hdv).  Skv may differ from S only for causal=False without a
    window; hdv from hd only as 128 beside 192 on the card."""
    _validate(q, k, v, causal, window)
    _build.refuse_grad("flash_attention", "repro_torch.models.attention.flash_attention", q, k, v)
    _build.check_device("flash_attention", q)
    return _flash_op(q, k, v, causal, window)


@torch.library.custom_op("repro::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    if q.device.type == "cpu":
        # contiguous, as the fake implementation's (and the kernel's) output
        return ref.attention_ref(q, k, v, causal=causal, window=window).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {list(DTYPES)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dimension must be contiguous")
    for t in (q, k, v):
        _build.check_vector_aligned("flash_attention", t, (0, 1, 2))
    hdv = v.shape[3]
    lib = _build.load()
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    strides = _build.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            DTYPES[q.dtype], hd, hdv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, k.shape[1], H, k.shape[2], strides, int(causal),
            0 if window is None else window, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    if hdv != hd:
        mla_widths.launches += 1
    return out


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape[:3] + v.shape[3:])


def attention_pairs(S: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a head attends to under the mask."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(S, Skv, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(S, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flops(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs):
    """QKᵀ and PV over the unmasked pairs, 2 flops per FMA: the count that
    ``chip_smoke.py``'s kernel table bounds the kernel by."""
    B, S, H, hd = q_shape
    return 2 * (hd + v_shape[3]) * H * B * attention_pairs(S, k_shape[1], causal, window)


def sharding_rule(q, k, v, causal, window):
    """Batch may shard, and heads where the kv heads split evenly over the
    whole mesh (or there is one query head a kv head): a query head's group
    then stays on its rank.  The sequence and the head dimension may not."""
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate(), Replicate(), Replicate(), None, None]),
           ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None])]
    H, KV = q.shape[2], k.shape[2]
    if H == KV or KV % q.mesh.size() == 0:
        out.append(([Shard(2)], [Shard(2), Shard(2), Shard(2), None, None]))
    return out


flash_attention.launches = 0
mla_widths = types.SimpleNamespace(launches=0)     # those at q.k width 192, v width 128
