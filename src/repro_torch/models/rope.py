"""Rotary position embeddings: standard 1-D RoPE, Qwen2-VL M-RoPE and
DeepSeek-V2's YaRN.

Counterpart of the JAX package's ``models/rope.py``: frequencies
``theta ** (-2 dim / hd)`` in float32, and the rotation acts on split
halves ``[x1; x2]`` of the head dimension.  M-RoPE assigns the hd/2
frequency bands to (temporal, height, width) sections, each rotated by
its own coordinate; text tokens use t == h == w == position, so M-RoPE
on pure text is 1-D RoPE.  YaRN (``yarn_freqs``) blends RoPE's
frequencies with those divided by its factor along a linear ramp of the
frequency index, and DeepSeek-V2 rotates consecutive pairs (2i, 2i + 1)
of its rope columns (``rotate_pairs``), the published checkpoints' layout.

``position_table`` builds the rotation's (cos, sin) on the positions'
device from the Python theta, with no host tensor: a copy from the host
would block the card's stream.  Layers that rotate at the same positions
(a prefill's) share one table; ``rotate`` applies it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """``theta ** (-2 dim / hd)`` in float32, built on ``device`` from the
    Python float: no host tensor, so no blocking copy to the card."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -2.0 * dim / head_dim)     # (hd/2,)


def _yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor m(f, s) = 0.1 s ln f + 1 (1 for f <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_softmax_scale(factor: float, mscale_all_dim: float) -> float:
    """The factor m(f, mscale_all_dim)^2 on a YaRN model's softmax scale
    (DeepSeek's code, vLLM and transformers' deepseek_v3; 1 without one)."""
    return _yarn_mscale(factor, mscale_all_dim) ** 2 if mscale_all_dim else 1.0


# YaRN's ramp ends: the turns over the original context of the fastest band
# left as RoPE's and of the slowest divided by the factor (DeepSeek-V2's and
# transformers' defaults)
YARN_BETA_FAST, YARN_BETA_SLOW = 32.0, 1.0


def yarn_freqs(dim: int, theta: float, factor: float, original_max: int, device=None):
    """YaRN's frequencies for ``dim`` rotated columns, in float32 on
    ``device`` (transformers' ``_compute_yarn_parameters``): RoPE's
    (``rope_freqs``) where a band turns more than YARN_BETA_FAST times over
    the original context, those divided by ``factor`` where it turns fewer
    than YARN_BETA_SLOW times, a linear ramp of the band index between (its
    ends floored and ceiled).  The table's cos and sin are not scaled: the
    configurations' mscale equals their mscale_all_dim."""
    def band(turns):
        return dim * math.log(original_max / (turns * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(band(YARN_BETA_FAST)), 0)
    hi = min(math.ceil(band(YARN_BETA_SLOW)), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    band_ids = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = ((band_ids - lo) / (hi - lo)).clamp(0, 1)
    extra = rope_freqs(dim, theta, device)
    return extra / factor * ramp + extra * (1 - ramp)


def _section_index(sections: Tuple[int, int, int], device):
    """M-RoPE's section id per frequency band: 0 -> t, 1 -> h, 2 -> w."""
    return torch.cat([torch.full((n,), i, dtype=torch.int64, device=device)
                      for i, n in enumerate(sections)])


def position_table(positions, head_dim: int, theta: float,
                   sections: Optional[Tuple[int, int, int]] = None,
                   yarn: Optional[Tuple[float, int]] = None):
    """The rotation's (cos, sin), each (B, S, 1, hd/2) float32: RoPE at
    ``positions`` (B, S), or M-RoPE at ``positions`` (B, S, 3) (t, h, w
    coordinates) with ``sections``, the frequency-band counts for t, h and
    w, summing to hd/2; YaRN's frequencies where ``yarn`` gives its
    (factor, original context).
    ``position_table.built`` counts the tables built."""
    freqs = (rope_freqs(head_dim, theta, positions.device) if yarn is None
             else yarn_freqs(head_dim, theta, *yarn, device=positions.device))
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


def rotate_pairs(x, table):
    """Rotate x (B, S, H, hd) by ``position_table``'s (cos, sin), in float32;
    the consecutive columns (2i, 2i + 1) turn together at frequency i."""
    cos, sin = table
    xf = x.float().unflatten(-1, (-1, 2))
    x1, x2 = xf[..., 0], xf[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2).to(x.dtype)


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
