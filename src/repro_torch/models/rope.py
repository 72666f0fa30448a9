"""Rotary position embeddings: standard 1-D RoPE and Qwen2-VL M-RoPE.

Counterpart of the JAX package's ``models/rope.py``: frequencies
``theta ** (-2 dim / hd)`` in float32, and the rotation acts on split
halves ``[x1; x2]`` of the head dimension.  M-RoPE assigns the hd/2
frequency bands to (temporal, height, width) sections, each rotated by
its own coordinate; text tokens use t == h == w == position, so M-RoPE
on pure text is 1-D RoPE.

``position_table`` builds the rotation's (cos, sin) on the positions'
device from the Python theta, with no host tensor: a copy from the host
would block the card's stream.  Layers that rotate at the same positions
(a prefill's) share one table; ``rotate`` applies it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """``theta ** (-2 dim / hd)`` in float32, built on ``device`` from the
    Python float: no host tensor, so no blocking copy to the card."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -2.0 * dim / head_dim)     # (hd/2,)


def _section_index(sections: Tuple[int, int, int], device):
    """M-RoPE's section id per frequency band: 0 -> t, 1 -> h, 2 -> w."""
    return torch.cat([torch.full((n,), i, dtype=torch.int64, device=device)
                      for i, n in enumerate(sections)])


def position_table(positions, head_dim: int, theta: float,
                   sections: Optional[Tuple[int, int, int]] = None):
    """The rotation's (cos, sin), each (B, S, 1, hd/2) float32: RoPE at
    ``positions`` (B, S), or M-RoPE at ``positions`` (B, S, 3) (t, h, w
    coordinates) with ``sections``, the frequency-band counts for t, h and
    w, summing to hd/2.  ``position_table.built`` counts the tables built."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    if sections is None:
        coords = positions[..., None].float()                    # (B, S, 1)
    else:
        if sum(sections) != head_dim // 2:
            raise ValueError(f"M-RoPE: sections {sections} do not sum to {head_dim // 2}")
        coords = positions.float()[..., _section_index(sections, positions.device)]
    ang = coords * freqs                                         # (B, S, hd/2)
    position_table.built += 1
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


position_table.built = 0


def rotate(x, table):
    """Rotate x (B, S, H, hd) by ``position_table``'s (cos, sin), in float32;
    the halves [x1; x2] of the head dimension turn together."""
    cos, sin = table
    hd = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    if theta <= 0:
        return x
    return rotate(x, position_table(positions, x.shape[-1], theta))


def apply_m_rope(x, positions_thw, theta: float, sections: Tuple[int, int, int]):
    """x: (B, S, H, hd); positions_thw: (B, S, 3) int (t, h, w coordinates);
    sections: frequency-band counts for t, h and w, summing to hd/2."""
    return rotate(x, position_table(positions_thw, x.shape[-1], theta, sections))


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
