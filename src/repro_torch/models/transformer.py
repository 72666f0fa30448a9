"""Model assembly for dense decoder-only transformers ("attn" blocks).

Counterpart of the JAX package's ``models/transformer.py`` for the
serving path of a dense model: ``init_params``, ``init_cache``,
``prefill`` and ``decode_step``.  Parameters mirror the JAX tree except
that ``params["blocks"]`` is a list with one dict per layer where JAX
stacks a leading layer axis; the JAX ``lax.scan`` over layers becomes a
Python loop.  Other block kinds and features raise
``NotImplementedError`` naming the slice of the port that brings them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L


def check_supported(cfg: ArchConfig):
    """Raise for what this slice of the port does not run yet."""
    kinds = set(cfg.pattern)
    if "rwkv6" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: RWKV6 blocks arrive with the rwkv6-1.6b slice (rwkv6_scan)")
    if "mamba2" in kinds or cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 and shared-attention blocks arrive with the "
            "zamba2-2.7b slice (ssd_scan)")
    if kinds != {"attn"}:
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(kinds)}")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE blocks arrive with the MoE slice")
    if cfg.encoder_layers or cfg.cross_attention or cfg.frontend or cfg.m_rope:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention, frontends and M-RoPE "
            "arrive with the encoder/vision slice")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ArchConfig, device):
    return {
        "ln1": L.init_norm(cfg.d_model, device),
        "attn": attn_lib.init_attention(generator, cfg, device),
        "ln2": L.init_norm(cfg.d_model, device),
        "ffn": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device, cfg.act_fn),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (which lives on ``device``)."""
    check_supported(cfg)
    p: Dict[str, Any] = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "final_norm": L.init_norm(cfg.d_model, device),
        "blocks": [_init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["head"] = L.init_head(generator, cfg.d_model, cfg.vocab_size, device)
    return p


def _logits(params, cfg: ArchConfig, x):
    """Final norm + unembedding in float32."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps).float()
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].float().T
    return x @ params["head"]["w"].float()


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               dtype=torch.bfloat16, window: Optional[int] = None,
               device=None):
    """One heads-major KV cache per layer, plus the decode step."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    return {"step": 0,
            "layers": [attn_lib.init_kv_cache(batch_size, max_len, cfg,
                                              window=window, dtype=dtype,
                                              device=device)
                       for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _block(bp, x, cfg: ArchConfig, attend):
    h, _ = attend(bp["attn"], L.apply_norm(bp["ln1"], x, cfg.norm_eps))
    x = x + h
    return x + L.apply_mlp(bp["ffn"], L.apply_norm(bp["ln2"], x, cfg.norm_eps),
                           cfg.act_fn)


def prefill(params, cfg: ArchConfig, batch, cache):
    """Run the prompt through the model in one pass; returns the last
    token's logits (B, V) in float32 and the filled cache (in place)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = L.embed(params["embed"], tokens)
    for bp, lc in zip(params["blocks"], cache["layers"]):
        x = _block(bp, x, cfg,
                   lambda p, xin, lc=lc: attn_lib.attention_prefill(p, xin, cfg, lc))
    cache["step"] = S
    return _logits(params, cfg, x[:, -1, :]), cache


def decode_step(params, cfg: ArchConfig, token, cache):
    """token: (B, 1) int -> (logits (B, 1, V) float32, cache updated in place)."""
    x = L.embed(params["embed"], token)
    for bp, lc in zip(params["blocks"], cache["layers"]):
        x = _block(bp, x, cfg,
                   lambda p, xin, lc=lc: attn_lib.attention_decode(p, xin, cfg, lc))
    cache["step"] += 1
    return _logits(params, cfg, x), cache
