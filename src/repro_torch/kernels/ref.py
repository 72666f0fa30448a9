"""Plain PyTorch versions of the attention kernels (exact, unchunked).

They compute what ``csrc/attention.cu`` computes, in float32, with the
same finite ``NEG_INF`` mask.  The CPU path of the wrappers runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
Counterpart of the JAX package's ``kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """Naive quadratic attention. q: (B,S,H,hd); k,v: (B,S,KV,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    qi = torch.arange(S, device=q.device)[:, None]
    si = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= si <= qi
    if window is not None:
        mask &= si > qi - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def decode_attention_ref(q, k, v, q_positions, kv_positions, *,
                         window: Optional[int] = None):
    """q: (B,1,H,hd); k,v: (B,S,KV,hd); q_positions (B,), kv_positions
    (B,S) absolute positions, -1 for never-written slots.  A row with no
    valid slot gets uniform weights, i.e. mean(V), as in the kernel."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    kp = kv_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, None, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
