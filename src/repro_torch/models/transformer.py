"""Model assembly for the served families: dense decoder-only transformers
("attn" blocks), RWKV6 ("rwkv6" blocks) and Mamba2 with Zamba2's shared
attention ("mamba2" blocks, ``shared_attn_every``).

Counterpart of the JAX package's ``models/transformer.py`` for the
serving path: ``init_params``, ``init_cache``, ``prefill`` and
``decode_step``, plus ``reset_cache``.  Parameters mirror the JAX tree
except that ``params["blocks"]`` is a list with one dict per layer where
JAX stacks a leading layer axis; the JAX ``lax.scan`` over layers (and
over zamba2's groups) becomes a Python loop.  Other block kinds and
features raise ``NotImplementedError`` naming the slice of the port that
brings them.

The cache is updated in place.  A recurrent prefill starts from the
cache's state, as in JAX; ``reset_cache`` zeros every recurrent state,
conv tail and token shift, so a reused cache starts where a fresh one
does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib


def check_supported(cfg: ArchConfig):
    """Raise for what this slice of the port does not run yet."""
    kinds = set(cfg.pattern)
    if len(kinds) != 1 or not kinds <= {"attn", "rwkv6", "mamba2"}:
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(kinds)}")
    if cfg.shared_attn_every and (kinds != {"mamba2"} or cfg.n_layers % cfg.shared_attn_every):
        raise NotImplementedError(
            f"{cfg.name}: shared attention runs every k Mamba2 layers, k dividing n_layers")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE blocks arrive with the MoE slice")
    if cfg.encoder_layers or cfg.cross_attention or cfg.frontend or cfg.m_rope:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention, frontends and M-RoPE "
            "arrive with the encoder/vision slice")
    if kinds == {"attn"} and cfg.act_fn != "silu":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.act_fn.upper()} MLP with b_up / b_down arrives "
            "with the dense-family slice (ROADMAP Queue 1, item 9)")


def _kind(cfg: ArchConfig) -> str:
    return cfg.pattern[0]


def _groups(cfg: ArchConfig) -> int:
    """Zamba2: applications of the shared attention block (one per group of
    ``shared_attn_every`` Mamba2 layers); 0 for other families."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ArchConfig, device, kind: str):
    if kind == "attn":
        return {
            "ln1": L.init_norm(cfg.d_model, device),
            "attn": attn_lib.init_attention(generator, cfg, device),
            "ln2": L.init_norm(cfg.d_model, device),
            "ffn": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device, cfg.act_fn),
        }
    if kind == "mamba2":
        return {"ln1": L.init_norm(cfg.d_model, device),
                "mamba": ssm_lib.init_mamba2(generator, cfg, device)}
    return {"ln1": L.init_norm(cfg.d_model, device, with_bias=True),
            "ln2": L.init_norm(cfg.d_model, device, with_bias=True),
            "rwkv": rwkv_lib.init_rwkv6(generator, cfg, device)}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (which lives on ``device``)."""
    check_supported(cfg)
    p: Dict[str, Any] = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "final_norm": L.init_norm(cfg.d_model, device),
        "blocks": [_init_block(generator, cfg, device, _kind(cfg))
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["head"] = L.init_head(generator, cfg.d_model, cfg.vocab_size, device)
    if cfg.shared_attn_every:
        p["shared_attn"] = _init_block(generator, cfg, device, "attn")
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
    """One cache per layer (heads-major KV, or recurrent state), zamba2's
    shared-attention KV caches (one per application), and the decode step."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    kind = _kind(cfg)
    if kind == "attn":
        make = lambda: attn_lib.init_kv_cache(batch_size, max_len, cfg, window=window,
                                              dtype=dtype, device=device)
    elif kind == "mamba2":
        make = lambda: ssm_lib.init_mamba_cache(batch_size, cfg, dtype=dtype, device=device)
    else:
        make = lambda: rwkv_lib.init_rwkv_cache(batch_size, cfg, dtype=dtype, device=device)
    cache = {"step": 0, "layers": [make() for _ in range(cfg.n_layers)]}
    if cfg.shared_attn_every:
        # the JAX package windows the shared block only past 64k tokens
        w = window if window is not None else (4096 if max_len > 65536 else None)
        cache["shared"] = [attn_lib.init_kv_cache(batch_size, max_len, cfg, window=w,
                                                  dtype=dtype, device=device)
                           for _ in range(_groups(cfg))]
    return cache


def reset_cache(cache):
    """Zero every recurrent state, conv tail and token shift in place (a KV
    cache needs none: a prefill overwrites all its slots)."""
    for lc in cache["layers"]:
        if not isinstance(lc, attn_lib.KVCache):
            lc.reset()
    cache["step"] = 0
    return cache


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _attn_block(bp, x, cfg: ArchConfig, attend):
    h, _ = attend(bp["attn"], L.apply_norm(bp["ln1"], x, cfg.norm_eps))
    x = x + h
    return x + L.apply_mlp(bp["ffn"], L.apply_norm(bp["ln2"], x, cfg.norm_eps),
                           cfg.act_fn)


def _rwkv_prefill(bp, x, cfg, lc):
    h, (last_x, s_fin) = rwkv_lib.time_mix(
        bp["rwkv"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg, s0=lc.state)
    x = x + h
    h, last_cm = rwkv_lib.channel_mix(
        bp["rwkv"], L.apply_norm(bp["ln2"], x, cfg.norm_eps), cfg)
    lc.x_tm.copy_(last_x)
    lc.x_cm.copy_(last_cm)
    lc.state.copy_(s_fin)
    return x + h


def _rwkv_decode(bp, x, cfg, lc):
    h, _ = rwkv_lib.rwkv6_decode(bp["rwkv"], L.apply_norm(bp["ln1"], x, cfg.norm_eps),
                                 cfg, lc)
    x = x + h
    h, _ = rwkv_lib.channel_mix_decode(
        bp["rwkv"], L.apply_norm(bp["ln2"], x, cfg.norm_eps), cfg, lc)
    return x + h


def _run_blocks(params, cfg: ArchConfig, x, cache, attend, mamba, rwkv):
    """Every block in order; for zamba2 the shared attention block (with
    the KV cache of its application) before each group of Mamba2 layers."""
    every, kind = cfg.shared_attn_every, _kind(cfg)
    for i, (bp, lc) in enumerate(zip(params["blocks"], cache["layers"])):
        if every and i % every == 0:
            x = _attn_block(params["shared_attn"], x, cfg,
                            lambda p, xin, sc=cache["shared"][i // every]: attend(p, xin, sc))
        if kind == "attn":
            x = _attn_block(bp, x, cfg, lambda p, xin, lc=lc: attend(p, xin, lc))
        elif kind == "mamba2":
            h, _ = mamba(bp["mamba"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg, lc)
            x = x + h
        else:
            x = rwkv(bp, x, cfg, lc)
    return x


def prefill(params, cfg: ArchConfig, batch, cache):
    """Run the prompt through the model in one pass; returns the last
    token's logits (B, V) in float32 and the filled cache (in place)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    x = _run_blocks(params, cfg, x, cache,
                    lambda p, xin, lc: attn_lib.attention_prefill(p, xin, cfg, lc),
                    ssm_lib.mamba2_prefill, _rwkv_prefill)
    cache["step"] = tokens.shape[1]
    return _logits(params, cfg, x[:, -1, :]), cache


def decode_step(params, cfg: ArchConfig, token, cache):
    """token: (B, 1) int -> (logits (B, 1, V) float32, cache updated in place)."""
    x = L.embed(params["embed"], token)
    x = _run_blocks(params, cfg, x, cache,
                    lambda p, xin, lc: attn_lib.attention_decode(p, xin, cfg, lc),
                    ssm_lib.mamba2_decode, _rwkv_decode)
    cache["step"] += 1
    return _logits(params, cfg, x), cache
