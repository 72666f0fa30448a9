"""Rotary position embeddings (standard 1-D RoPE).

Counterpart of the JAX package's ``models/rope.py``: frequencies
``theta ** (-2 dim / hd)`` in float32, and the rotation acts on split
halves ``[x1; x2]`` of the head dimension.  M-RoPE (qwen2-vl) arrives
with the vision slice.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return base ** (-2.0 * dim / head_dim)             # (hd/2,)


def _rotate(x, cos, sin):
    # x: (..., hd) split into halves [x1; x2]
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs                 # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]                         # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
