"""Mamba2 (SSD) block, as used by Zamba2. [arXiv:2405.21060, 2411.15242]

Counterpart of the JAX package's ``models/ssm.py`` for serving: in_proj ->
[z | xBC | dt], causal depthwise conv over xBC, scalar-decay SSD per head,
gated RMSNorm, out_proj.  The prompt's SSD goes through the ``ssd_scan``
kernel (CUDA on the card, its plain version on the CPU); a decode step is
a single state update in plain tensor ops.

B and C stay in group form (B, S, N) (G = 1: all heads share them) and
reach the kernel as a view expanded over the heads, with no copy.  The
decode cache is updated in place: the functions write into
``cache.conv`` and ``cache.ssm``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, rms_norm


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
    G, N = 1, cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    return d_in, heads, G, N, conv_dim


def init_mamba2(generator, cfg, device):
    d = cfg.d_model
    d_in, H, G, N, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=device)
    dt = torch.exp(torch.empty((H,), **f32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator))
    return {
        "in_proj": _dense_init((d, proj_out), generator, device),
        "conv_w": 0.1 * torch.empty((cfg.d_conv, conv_dim), **f32).normal_(generator=generator),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),      # inverse-softplus init
        "norm": torch.zeros((d_in,), **f32),
        "out_proj": _dense_init((d_in, d), generator, device),
    }


@dataclasses.dataclass
class MambaCache:
    conv: torch.Tensor    # (B, d_conv - 1, conv_dim) trailing inputs
    ssm: torch.Tensor     # (B, H, hd, N) state, float32

    def reset(self):
        self.conv.zero_()
        self.ssm.zero_()


def init_mamba_cache(batch, cfg, dtype=torch.float32, device=None):
    d_in, H, G, N, conv_dim = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, d_in // H, N), dtype=torch.float32, device=device),
    )


def _split_proj(p, x, cfg):
    d_in, H, G, N, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over a prompt, zero history. xBC: (B,S,C);
    w: (taps, C)."""
    taps, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, taps - 1, 0))
    y = sum(pad[:, i:i + S, :] * w[i] for i in range(taps))
    return F.silu(y + b)


def _ssm_inputs(p, xBC, dt, cfg):
    """xh (B,S,H,hd); Bm, Cm in group form (B,S,N); dt and dA (B,S,H)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    B_, S = xBC.shape[0], xBC.shape[1]
    xh = xBC[..., :d_in].reshape(B_, S, H, d_in // H)
    Bm = xBC[..., d_in:d_in + G * N]
    Cm = xBC[..., d_in + G * N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    dA = dt * -torch.exp(p["A_log"])                       # <= 0
    return xh, Bm, Cm, dt, dA


def mamba2_prefill(p, x, cfg, cache: MambaCache):
    """Prompt pass from the cache's SSD state; leaves the final state and the
    conv tail in the cache.  x: (B,S,d) -> (out, cache)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    B_, S = x.shape[0], x.shape[1]
    z, xBC, dt = _split_proj(p, x, cfg)
    tail = xBC[:, -(cfg.d_conv - 1):, :]
    xBC = _causal_conv(xBC, p["conv_w"].to(xBC.dtype), p["conv_b"].to(xBC.dtype))
    xh, Bm, Cm, dtf, dA = _ssm_inputs(p, xBC, dt, cfg)
    xdt = xh * dtf.to(xh.dtype)[..., None]
    y, h_fin = ops.ssd_scan(xdt, Bm[:, :, None].expand(B_, S, H, N),
                            Cm[:, :, None].expand(B_, S, H, N), dA, h0=cache.ssm)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    cache.conv.zero_()
    cache.conv[:, cache.conv.shape[1] - tail.shape[1]:] = tail
    cache.ssm.copy_(h_fin)
    return y @ p["out_proj"], cache


def mamba2_decode(p, x, cfg, cache: MambaCache):
    """One-step decode, plain tensor ops. x: (B,1,d) -> (out, cache)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    z, xBC, dt = _split_proj(p, x, cfg)
    window = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)        # (B,d_conv,C)
    y_conv = torch.einsum("btc,tc->bc", window, p["conv_w"].to(xBC.dtype))
    xBC1 = F.silu(y_conv + p["conv_b"].to(xBC.dtype))[:, None, :]       # (B,1,C)
    xh, Bm, Cm, dtf, dA = _ssm_inputs(p, xBC1, dt, cfg)
    xdt = (xh * dtf[..., None])[:, 0]                                   # (B,H,hd)
    decay = torch.exp(dA[:, 0])                                         # (B,H)
    h = cache.ssm * decay[..., None, None] + (
        xdt.float()[..., :, None] * Bm[:, 0].float()[:, None, None, :])
    y = torch.einsum("bn,bhdn->bhd", Cm[:, 0].float(), h)
    y = y + xh[:, 0].float() * p["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    cache.conv.copy_(window[:, 1:, :])
    cache.ssm.copy_(h)
    return y @ p["out_proj"], cache
