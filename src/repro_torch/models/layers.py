"""Core layers: norms, MLPs, embeddings, parameter init.

Parameters are plain nested dicts of tensors, with the JAX package's
names and layouts (weights stored (in, out), used as ``x @ w``), so a JAX
parameter tree converts leaf for leaf (``models/convert.py``).
Initialisation draws from an explicit ``torch.Generator`` on the target
device; its numbers differ from ``jax.random``'s, so parity tests share
weights through ``convert.params_from_jax`` instead of seeds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dense_init(shape, generator, device, in_axis: int = 0,
                dtype=torch.float32):
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm in float32; the scale is stored zero-centred (1 + scale)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in float32 (scale stored as is, not zero-centred)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(d, device, *, with_bias: bool = False):
    """RMSNorm: a zero-centred scale; LayerNorm (with_bias): scale 1, bias 0."""
    if not with_bias:
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(p, x, eps=1e-5):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d, ff, device, act_fn: str = "silu"):
    if act_fn == "silu":
        return {
            "w_gate": _dense_init((d, ff), generator, device),
            "w_up": _dense_init((d, ff), generator, device),
            "w_down": _dense_init((ff, d), generator, device),
        }
    return {
        "w_up": _dense_init((d, ff), generator, device),
        "b_up": torch.zeros((ff,), dtype=torch.float32, device=device),
        "w_down": _dense_init((ff, d), generator, device),
        "b_down": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def apply_mlp(p, x, act_fn: str = "silu"):
    if act_fn == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu, which the JAX package calls, is the tanh approximation
    # by default; torch's default is the exact erf form
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab, d, device):
    return {"table": _dense_init((vocab, d), generator, device, in_axis=1)}


def embed(p, tokens):
    return p["table"][tokens]


def init_head(generator, d, vocab, device):
    return {"w": _dense_init((d, vocab), generator, device)}
