"""Flash-decode attention on Hopper: wrapper of ``decode_attn_kernel``.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``: one
query token per sequence against a KV cache, GQA, absolute kv positions
(-1 = never-written slot) and an optional sliding window.  On a CUDA
tensor it launches the CUDA kernels in ``csrc/attention.cu`` (one pass
over the cache cut into chunks, then a pass that combines the chunks);
on a CPU tensor it runs the plain ``ref.decode_attention_ref``.  There
is no other path.

k and v may be any strided view whose head dimension is contiguous, so
the engine hands over its heads-major cache ``(B, KV, S, hd)`` as
``cache.k.transpose(1, 2)`` without a copy.

``decode_attention.launches`` counts the calls that launched the kernels.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES

TILE = 64                 # cache slots per kernel tile: no chunk is shorter


def n_split(batch: int, kv_heads: int, slots: int, sms: int) -> int:
    """Chunks to cut each (batch, kv head)'s cache into: enough blocks for
    two per SM, and no more chunks than tiles."""
    return max(1, min(-(-slots // TILE), -(-2 * sms // (batch * kv_heads))))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _validate(q, k, v, q_positions, kv_positions, window):
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q (B,1,H,hd), k/v (B,S,KV,hd)")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} disagree")
    if tuple(q_positions.shape) != (B,) or tuple(kv_positions.shape) != (B, S):
        raise ValueError("decode_attention: q_positions (B,), kv_positions (B,S)")
    devs = {t.device for t in (q, k, v, q_positions, kv_positions)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention: tensors on devices {devs}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("decode_attention: q, k, v of different dtypes")


def decode_attention(q, k, v, q_positions, kv_positions, *,
                     window: Optional[int] = None):
    """q: (B, 1, H, hd); k, v: (B, S, KV, hd); q_positions: (B,) int32;
    kv_positions: (B, S) int32.  Returns (B, 1, H, hd)."""
    _validate(q, k, v, q_positions, kv_positions, window)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, q_positions, kv_positions,
                                        window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not in {list(DTYPES)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: the head dimension must be contiguous")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("decode_attention: positions must be int32")
    q_positions = q_positions.contiguous()
    if kv_positions.stride(1) != 1:
        kv_positions = kv_positions.contiguous()
    for t in (k, v):
        _build.check_vector_aligned("decode_attention", t, (0, 1, 2))
    lib = _build.load()
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    splits = n_split(B, KV, S, _sm_count(q.device))
    work = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32, device=q.device)
    strides = _build.strides_arg((q, (0, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                                 (kv_positions, (0,)))
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
            work.data_ptr(), splits, B, S, H, KV, strides,
            0 if window is None else window, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
