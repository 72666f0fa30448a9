"""Rotary position embeddings: standard 1-D RoPE and Qwen2-VL M-RoPE.

Counterpart of the JAX package's ``models/rope.py``: frequencies
``theta ** (-2 dim / hd)`` in float32, and the rotation acts on split
halves ``[x1; x2]`` of the head dimension.  M-RoPE assigns the hd/2
frequency bands to (temporal, height, width) sections, each rotated by
its own coordinate; text tokens use t == h == w == position, so M-RoPE
on pure text is 1-D RoPE.
"""
from __future__ import annotations

from typing import Tuple

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


def _apply_angles(x, ang):
    """Rotate x (B, S, H, hd) by angles (B, S, hd/2), in float32."""
    cos = torch.cos(ang)[..., None, :]                         # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _apply_angles(x, positions[..., None].float() * freqs)


def apply_m_rope(x, positions_thw, theta: float, sections: Tuple[int, int, int]):
    """x: (B, S, H, hd); positions_thw: (B, S, 3) int (t, h, w coordinates);
    sections: frequency-band counts for t, h and w, summing to hd/2."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"apply_m_rope: sections {sections} do not sum to {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    # section id per frequency band: 0 -> t, 1 -> h, 2 -> w
    sec = torch.repeat_interleave(torch.arange(3, device=x.device),
                                  torch.tensor(sections, device=x.device), output_size=hd // 2)
    coords = positions_thw.float()[..., sec]                   # (B, S, hd/2)
    return _apply_angles(x, coords * freqs)


def text_positions_thw(positions):
    """Text tokens: t == h == w == pos. positions: (B, S) -> (B, S, 3)."""
    return torch.stack([positions, positions, positions], dim=-1)


def vision_positions_thw(batch: int, n_patches: int, t0: int = 0, device=None):
    """Patch grid coordinates of the vision stub: one frame, a square grid
    of side int(sqrt(n_patches)). -> (batch, n_patches, 3) int32."""
    side = max(1, int(n_patches ** 0.5))
    idx = torch.arange(n_patches, device=device)
    thw = torch.stack([torch.full_like(idx, t0), idx // side, idx % side], dim=-1)
    return thw[None].expand(batch, n_patches, 3).to(torch.int32)
