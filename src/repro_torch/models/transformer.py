"""Model assembly for the served families: decoder-only transformers
("attn" blocks, with a SwiGLU or GELU MLP or a top-k MoE layer), qwen2-vl
("attn" blocks with M-RoPE and the vision stub), whisper (an encoder of
"attn" blocks and a decoder whose blocks cross-attend to it), RWKV6
("rwkv6" blocks), Mamba2 with Zamba2's shared attention ("mamba2"
blocks, ``shared_attn_every``) and granite-4.0-h's mix of "mamba2" and
"attn" layers, each followed by its FFN (``cfg.mamba_ffn``: the dropless
MoE and its shared expert), with its muP multipliers on the embedding,
every residual branch and the logits, and DeepSeek-V2 ("attn" blocks of
multi-head latent attention, ``cfg.mla``, each with a latent cache; a
dense MLP in the first ``first_dense_layers``, the dropless MoE after).

Counterpart of the JAX package's ``models/transformer.py``: for serving
``init_params``, ``init_cache``, ``prefill`` and ``decode_step``, plus
``reset_cache``; for training ``cast_params``, ``forward`` and
``train_loss``, whose gradient reaches the kernels through their
``torch.autograd.Function`` wrappers; for the mesh ``param_specs``,
``abstract_params`` and ``ShardingHints``.  Parameters mirror the JAX tree
except that ``params["blocks"]`` and ``params["encoder"]`` are lists with
one dict per layer where JAX stacks a leading layer axis; the JAX
``lax.scan`` over layers (and over zamba2's groups) becomes a Python loop.
The modality frontends are stubs, as in JAX: a prefill batch carries
precomputed ``frames`` (whisper) or ``patches`` (qwen2-vl) beside its
``tokens``.

The cache is updated in place.  A recurrent prefill starts from the
cache's state, as in JAX; ``reset_cache`` zeros every recurrent state,
conv tail and token shift and qwen2-vl's M-RoPE offset, so a reused cache
starts where a fresh one does.  A mixed pattern's cache holds a KV cache
for each attention layer beside the conv tail and SSD state of each Mamba2
layer.  ``step`` and ``mrope_delta`` are host
ints (they follow from shapes).

While a profiler records, ``prefill`` and ``decode_step`` emit the spans
``model.embed``, ``model.mix`` and ``model.ffn`` (each block's mixer and
its MLP or channel mix, each with its norm) and ``model.head``
(``profiling/spans.py``); inside ``model.ffn`` the dropless MoE emits
``model.moe.route``, ``model.moe.experts`` and ``model.moe.shared``
(``models/moe.py``); ``forward`` emits none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import P, constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.profiling.spans import span
from repro_torch.tree import tree_map


def check_supported(cfg: ArchConfig):
    """Raise for a configuration the assembly does not build: a
    non-uniform block pattern (as the JAX package's ``_uniform_kind``) other
    than a mix of "mamba2" and "attn" layers without zamba2's shared
    attention, and encoders, cross-attention, frontends or M-RoPE on other
    than "attn" blocks."""
    kinds = set(cfg.pattern)
    mixed = kinds == {"attn", "mamba2"} and not cfg.shared_attn_every
    if not (len(kinds) == 1 or mixed) or not kinds <= {"attn", "rwkv6", "mamba2"}:
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(kinds)}")
    if cfg.shared_attn_every and (kinds != {"mamba2"} or cfg.n_layers % cfg.shared_attn_every):
        raise NotImplementedError(
            f"{cfg.name}: shared attention runs every k Mamba2 layers, k dividing n_layers")
    if (cfg.encoder_layers or cfg.cross_attention or cfg.frontend or cfg.m_rope) \
            and kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention, frontends and M-RoPE need attention blocks")
    if cfg.cross_attention != bool(cfg.encoder_layers):
        raise NotImplementedError(f"{cfg.name}: cross-attention reads an encoder's output")
    if cfg.mla and (kinds != {"attn"} or cfg.encoder_layers or cfg.frontend or cfg.m_rope
                    or cfg.sliding_window or cfg.qk_norm or cfg.qkv_bias
                    or cfg.hd != cfg.qk_nope_head_dim + cfg.qk_rope_head_dim):
        raise NotImplementedError(f"{cfg.name}: MLA runs in plain causal attention blocks, "
                                  "its head width the nope and rope widths' sum")
    if cfg.yarn and not cfg.yarn_mscale_all_dim:
        raise NotImplementedError(f"{cfg.name}: YaRN without mscale_all_dim scales the "
                                  "table's cos / sin by m(f, 1); the port's is unscaled")
    if cfg.first_dense_layers and not cfg.moe_dropless:
        raise NotImplementedError(f"{cfg.name}: leading dense layers before a dropless MoE only")


@dataclasses.dataclass(frozen=True)
class ShardingHints:
    """Resolved specs injected by the launch layer (``launch/steps.py``).

    Each names the layout an activation takes at the JAX package's
    ``with_sharding_constraint`` sites: where the tensor is a DTensor on
    ``mesh`` it is redistributed to the spec's placements, and anything
    else passes as it is, so the default (no hints) leaves the served and
    trained paths unchanged."""
    residual: Optional[P] = None      # (B, S, D)
    logits: Optional[P] = None        # (B, s_chunk, V)
    kv: Optional[P] = None            # (B, S, KV, hd)
    # MoE: specs for the per-layer expert weights after the compute cast
    moe_w_in: Optional[P] = None      # (E, D, F)
    moe_w_out: Optional[P] = None     # (E, F, D)
    # expert parallelism (tokens move): (ep_axis, batch_axes) or None
    moe_ep: Optional[tuple] = None
    mesh: Any = None                  # the DeviceMesh the specs name


NO_HINTS = ShardingHints()


def _c(x, spec, shard: ShardingHints):
    return constrain(x, spec, shard.mesh)


def _groups(cfg: ArchConfig) -> int:
    """Zamba2: applications of the shared attention block (one per group of
    ``shared_attn_every`` Mamba2 layers); 0 for other families."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_ffn(generator, cfg: ArchConfig, device, layer: int = 0):
    if not cfg.is_dense_layer(layer):
        return {"moe": moe_lib.init_moe(generator, cfg, device)}
    return {"ffn": L.init_mlp(generator, cfg.d_model, cfg.dense_d_ff or cfg.d_ff, device,
                              cfg.act_fn)}


def _init_block(generator, cfg: ArchConfig, device, kind: str, *, cross: bool = False,
                layer: int = 0):
    if kind == "attn":
        ln_bias = cfg.family == "encdec"            # whisper: LayerNorm with a bias
        p = {"ln1": L.init_norm(cfg.d_model, device, with_bias=ln_bias),
             "attn": attn_lib.init_attention(generator, cfg, device),
             "ln2": L.init_norm(cfg.d_model, device, with_bias=ln_bias),
             **_init_ffn(generator, cfg, device, layer)}
        if cross:
            p["ln_c"] = L.init_norm(cfg.d_model, device, with_bias=ln_bias)
            p["cross"] = attn_lib.init_attention(generator, cfg, device)
        return p
    if kind == "mamba2":
        p = {"ln1": L.init_norm(cfg.d_model, device),
             "mamba": ssm_lib.init_mamba2(generator, cfg, device)}
        if cfg.mamba_ffn:
            p.update(ln2=L.init_norm(cfg.d_model, device),
                     **_init_ffn(generator, cfg, device, layer))
        return p
    return {"ln1": L.init_norm(cfg.d_model, device, with_bias=True),
            "ln2": L.init_norm(cfg.d_model, device, with_bias=True),
            "rwkv": rwkv_lib.init_rwkv6(generator, cfg, device)}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (which lives on ``device``)."""
    check_supported(cfg)
    p: Dict[str, Any] = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "final_norm": L.init_norm(cfg.d_model, device, with_bias=cfg.family == "encdec"),
        "blocks": [_init_block(generator, cfg, device, kind, cross=cfg.cross_attention, layer=i)
                   for i, kind in enumerate(cfg.pattern)],
    }
    if not cfg.tie_embeddings:
        p["head"] = L.init_head(generator, cfg.d_model, cfg.vocab_size, device)
    if cfg.shared_attn_every:
        p["shared_attn"] = _init_block(generator, cfg, device, "attn")
    if cfg.encoder_layers:
        p["encoder"] = [_init_block(generator, cfg, device, "attn")
                        for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = L.init_norm(cfg.d_model, device, with_bias=True)
    if cfg.frontend == "vision" and cfg.frontend_dim:
        p["vis_proj"] = {"w": L._dense_init((cfg.frontend_dim, cfg.d_model), generator, device),
                         "b": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}
    return p


def _specs_block(cfg: ArchConfig, kind: str, *, cross: bool = False, layer: int = 0):
    """One layer's logical specs: the JAX package's stacked spec without
    its leading None (the port keeps one dict per layer)."""
    ffn = ({"ffn": L.specs_mlp(cfg.act_fn)} if cfg.is_dense_layer(layer)
           else {"moe": moe_lib.specs_moe(cfg)})
    if kind == "attn":
        ln_bias = cfg.family == "encdec"
        p = {"ln1": L.specs_norm(with_bias=ln_bias),
             "attn": attn_lib.specs_attention(cfg),
             "ln2": L.specs_norm(with_bias=ln_bias), **ffn}
        if cross:
            p["ln_c"] = L.specs_norm(with_bias=ln_bias)
            p["cross"] = attn_lib.specs_attention(cfg)
        return p
    if kind == "mamba2":
        p = {"ln1": L.specs_norm(), "mamba": ssm_lib.specs_mamba2(cfg)}
        if cfg.mamba_ffn:
            p.update(ln2=L.specs_norm(), **ffn)
        return p
    return {"ln1": L.specs_norm(with_bias=True), "ln2": L.specs_norm(with_bias=True),
            "rwkv": rwkv_lib.specs_rwkv6(cfg)}


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical specs (``P``) in the parameter tree's structure."""
    check_supported(cfg)
    s: Dict[str, Any] = {
        "embed": L.specs_embedding(),
        "final_norm": L.specs_norm(with_bias=cfg.family == "encdec"),
        "blocks": [_specs_block(cfg, kind, cross=cfg.cross_attention, layer=i)
                   for i, kind in enumerate(cfg.pattern)],
    }
    if not cfg.tie_embeddings:
        s["head"] = L.specs_head()
    if cfg.shared_attn_every:
        s["shared_attn"] = _specs_block(cfg, "attn")
    if cfg.encoder_layers:
        s["encoder"] = [_specs_block(cfg, "attn") for _ in range(cfg.encoder_layers)]
        s["enc_norm"] = L.specs_norm(with_bias=True)
    if cfg.frontend == "vision" and cfg.frontend_dim:
        s["vis_proj"] = {"w": P("fsdp", "tp"), "b": P(None)}
    return s


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameter tree on the meta device: shapes and dtypes only, no
    storage and no random draw (``init_params`` with no generator there).
    As in the JAX package, whose per-layer leaves carry a stacked layer
    axis, matrices and every per-layer leaf take ``dtype``; the other
    vectors stay float32."""
    shapes = init_params(cfg, None, torch.device("meta"))
    cast = lambda a: a.to(dtype)
    keep_vectors = lambda a: a.to(dtype) if a.dim() >= 2 else a
    return {k: tree_map(cast if k in ("blocks", "encoder") else keep_vectors, v)
            for k, v in shapes.items()}


def cast_params(params, dtype):
    """The compute cast: float32 matrices to ``dtype``, vectors (norm
    scales, biases) kept float32.  Differentiable, so the gradient reaches
    the float32 master copy."""
    return tree_map(lambda a: a.to(dtype) if a.dim() >= 2 and a.dtype == torch.float32
                    else a, params)


def _logits(params, cfg: ArchConfig, x, shard: ShardingHints = NO_HINTS):
    """Final norm + unembedding in float32, divided by ``logits_scaling``."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps).float()
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].float().T
    else:
        logits = x @ params["head"]["w"].float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits if logits.dim() < 3 else _c(logits, shard.logits, shard)


def _embed(params, cfg: ArchConfig, tokens):
    """The table's rows of ``tokens``, times ``embedding_multiplier``."""
    x = L.embed(params["embed"], tokens)
    return x if cfg.embedding_multiplier == 1.0 else x * cfg.embedding_multiplier


def _branch(cfg: ArchConfig, h):
    """A residual branch's output times ``residual_multiplier``."""
    return h if cfg.residual_multiplier == 1.0 else h * cfg.residual_multiplier


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               dtype=torch.bfloat16, window: Optional[int] = None,
               device=None):
    """One cache per layer (heads-major KV, MLA's latent cache, or recurrent
    state: in a mixed pattern each layer's of its own kind), zamba2's shared-attention KV
    caches (one per application), whisper's cross K/V (one (B, Se, KV, hd)
    pair per decoder layer, filled at prefill), qwen2-vl's M-RoPE offset,
    and the decode step."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window

    def make(kind):
        if kind == "attn" and cfg.mla:
            return attn_lib.init_latent_cache(batch_size, max_len, cfg, dtype=dtype,
                                              device=device)
        if kind == "attn":
            return attn_lib.init_kv_cache(batch_size, max_len, cfg, window=window,
                                          dtype=dtype, device=device)
        if kind == "mamba2":
            return ssm_lib.init_mamba_cache(batch_size, cfg, dtype=dtype, device=device)
        return rwkv_lib.init_rwkv_cache(batch_size, cfg, dtype=dtype, device=device)
    cache = {"step": 0, "layers": [make(kind) for kind in cfg.pattern]}
    if cfg.shared_attn_every:
        # the JAX package windows the shared block only past 64k tokens
        w = window if window is not None else (4096 if max_len > 65536 else None)
        cache["shared"] = [attn_lib.init_kv_cache(batch_size, max_len, cfg, window=w,
                                                  dtype=dtype, device=device)
                           for _ in range(_groups(cfg))]
    if cfg.m_rope:
        cache["mrope_delta"] = 0      # text-position offset set at prefill (grid compression)
    if cfg.encoder_layers:
        shape = (batch_size, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.hd)
        cache["cross"] = [(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
                          for _ in range(cfg.n_layers)]
    return cache


def reset_cache(cache):
    """Zero every recurrent state, conv tail and token shift, and the M-RoPE
    offset, in place (a KV cache, a latent cache and the cross K/V need
    none: a prefill overwrites all their slots)."""
    for lc in cache["layers"]:
        if not isinstance(lc, (attn_lib.KVCache, attn_lib.LatentCache)):
            lc.reset()
    cache["step"] = 0
    if "mrope_delta" in cache:
        cache["mrope_delta"] = 0
    return cache


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _attn_mix(bp, x, cfg: ArchConfig, attend, cross=None, shard: ShardingHints = NO_HINTS):
    """Attention, then whisper's cross-attention (``cross``), each after its
    norm, the residual in ``shard.residual``'s layout after each add."""
    h, _ = attend(bp["attn"], L.apply_norm(bp["ln1"], x, cfg.norm_eps))
    x = _c(x + _branch(cfg, h), shard.residual, shard)
    if cross is not None:
        x = _c(x + cross(bp["cross"], L.apply_norm(bp["ln_c"], x, cfg.norm_eps)),
               shard.residual, shard)
    return x


def _attn_ffn(bp, x, cfg: ArchConfig, layer: int = 0, shard: ShardingHints = NO_HINTS):
    """The MLP or the MoE layer after its norm -> (x, the MoE aux loss or
    None).  The dropless MoE (granite, DeepSeek-V2) has no aux loss."""
    xin = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
    if cfg.is_dense_layer(layer):
        return _c(x + L.apply_mlp(bp["ffn"], xin, cfg.act_fn), shard.residual, shard), None
    if cfg.moe_dropless:
        h = moe_lib.apply_moe_dropless(bp["moe"], xin, cfg, layer=layer)
        return _c(x + _branch(cfg, h), shard.residual, shard), None
    if shard.moe_ep is not None:
        ep_axis, baxes = shard.moe_ep
        h, aux = moe_lib.apply_moe_ep(bp["moe"], xin, cfg, mesh=shard.mesh,
                                      ep_axis=ep_axis, batch_axes=baxes)
    else:
        h, aux = moe_lib.apply_moe(bp["moe"], xin, cfg, layer=layer,
                                   w_specs=(shard.moe_w_in, shard.moe_w_out),
                                   mesh=shard.mesh)
    return _c(x + h, shard.residual, shard), aux


def _attn_block(bp, x, cfg: ArchConfig, attend, layer: int = 0, cross=None,
                shard: ShardingHints = NO_HINTS):
    """Attention, whisper's cross-attention (``cross``), then the MLP or the
    MoE layer -> (x, the MoE aux loss or None).  Serving discards the aux
    loss; the JAX decode step's chunk=1 picks the default's one chunk at
    S = 1."""
    return _attn_ffn(bp, _attn_mix(bp, x, cfg, attend, cross, shard), cfg, layer, shard)


def _served_attn_block(bp, x, cfg: ArchConfig, attend, layer: int = 0, cross=None,
                       shard: ShardingHints = NO_HINTS):
    """``_attn_block`` in a serving pass, its halves under the spans
    ``model.mix`` and ``model.ffn``; the aux loss discarded."""
    with span("model.mix"):
        x = _attn_mix(bp, x, cfg, attend, cross, shard)
    with span("model.ffn"):
        return _attn_ffn(bp, x, cfg, layer, shard)[0]


def _rwkv_prefill(bp, x, cfg, lc):
    with span("model.mix"):
        h, (last_x, s_fin) = rwkv_lib.time_mix(
            bp["rwkv"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg, s0=lc.state)
        lc.x_tm.copy_(last_x)
        lc.state.copy_(s_fin)
        x = x + h
    with span("model.ffn"):
        h, last_cm = rwkv_lib.channel_mix(
            bp["rwkv"], L.apply_norm(bp["ln2"], x, cfg.norm_eps), cfg)
        lc.x_cm.copy_(last_cm)
        return x + h


def _rwkv_decode(bp, x, cfg, lc):
    with span("model.mix"):
        h, _ = rwkv_lib.rwkv6_decode(bp["rwkv"], L.apply_norm(bp["ln1"], x, cfg.norm_eps),
                                     cfg, lc)
        x = x + h
    with span("model.ffn"):
        h, _ = rwkv_lib.channel_mix_decode(
            bp["rwkv"], L.apply_norm(bp["ln2"], x, cfg.norm_eps), cfg, lc)
        return x + h


def _run_blocks(params, cfg: ArchConfig, x, cache, attend, mamba, rwkv, cross=None,
                shard: ShardingHints = NO_HINTS):
    """Every block in order, each by its own kind; for zamba2 the shared
    attention block (with the KV cache of its application) before each
    group of Mamba2 layers; for whisper each block's cross-attention,
    ``cross(p, xin, k, v)``, to its layer's cross K/V; in a mixed pattern
    each Mamba2 layer's FFN after its mixer.  The residual takes
    ``shard.residual``'s layout after each block (the prefill's hint; the
    decode step passes none).  Each block's mixer runs under the span
    ``model.mix``, its MLP or channel mix under ``model.ffn``."""
    every = cfg.shared_attn_every
    for i, (kind, bp, lc) in enumerate(zip(cfg.pattern, params["blocks"], cache["layers"])):
        if every and i % every == 0:
            x = _served_attn_block(params["shared_attn"], x, cfg,
                                   lambda p, xin, sc=cache["shared"][i // every]:
                                   attend(p, xin, sc))
        if kind == "attn":
            xc = None if cross is None else (
                lambda p, xin, kv=cache["cross"][i]: cross(p, xin, *kv))
            x = _served_attn_block(bp, x, cfg, lambda p, xin, lc=lc: attend(p, xin, lc), i,
                                   xc, shard)
        elif kind == "mamba2":
            with span("model.mix"):
                h, _ = mamba(bp["mamba"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg, lc)
                x = _c(x + _branch(cfg, h), shard.residual, shard)
            if cfg.mamba_ffn:
                with span("model.ffn"):
                    x = _attn_ffn(bp, x, cfg, i, shard)[0]
        else:
            x = _c(rwkv(bp, x, cfg, lc), shard.residual, shard)
    return x


def _mrope_delta(cfg: ArchConfig, batch) -> Optional[int]:
    """qwen2-vl's text-position offset, side - Pn for Pn patches on a square
    grid of side int(sqrt(Pn)); None without patches or M-RoPE."""
    if not (cfg.frontend == "vision" and cfg.m_rope and "patches" in batch):
        return None
    Pn = batch["patches"].shape[1]
    return max(1, int(Pn ** 0.5)) - Pn


def prefill_host_fields(cfg: ArchConfig, batch) -> Dict[str, int]:
    """The cache's host fields a prefill of ``batch`` sets: ``step``, the
    prompt's length, and qwen2-vl's ``mrope_delta`` where patches come in.
    They follow from shapes alone."""
    out = {"step": batch["tokens"].shape[1]}
    delta = _mrope_delta(cfg, batch)
    if delta is not None:
        out["mrope_delta"] = delta
    return out


def _embed_inputs(params, cfg: ArchConfig, batch, shard: ShardingHints = NO_HINTS):
    """Token embeddings and the modality stub's merge -> (x, positions_thw).

    qwen2-vl: the projected patches replace the first Pn token embeddings;
    they take a square grid's M-RoPE positions and the text after them
    positions compressed to pos - Pn + side, so decoding continues at step
    + mrope_delta, mrope_delta = side - Pn (``_mrope_delta``).
    whisper: the sinusoidal table is added."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions_thw = None
    if cfg.frontend == "vision" and "patches" in batch:
        pe = batch["patches"]
        Pn = pe.shape[1]
        if "vis_proj" in params:
            pe = L.mm(pe, params["vis_proj"]["w"]) + params["vis_proj"]["b"]
        x = torch.cat([pe.to(x.dtype), x[:, Pn:]], dim=1)
        if cfg.m_rope:
            txt = (torch.arange(Pn, S, dtype=torch.int32, device=x.device)
                   + _mrope_delta(cfg, batch))
            positions_thw = torch.cat(
                [rope_lib.vision_positions_thw(B, Pn, device=x.device),
                 rope_lib.text_positions_thw(txt[None].expand(B, S - Pn))], dim=1)
    if cfg.family == "encdec":
        x = x + L.sinusoidal_positions(S, cfg.d_model, device=x.device).to(x.dtype)[None]
    return _c(x, shard.residual, shard), positions_thw


def _remat(fn, remat: bool):
    """fn, or fn recomputed in the backward (the JAX package's
    ``jax.checkpoint`` sites): its activations are not kept."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _encoder_forward(params, cfg: ArchConfig, frames, remat: bool = False,
                     shard: ShardingHints = NO_HINTS):
    """whisper's encoder over precomputed frame embeddings (B, Se, d): the
    sinusoidal table, then bidirectional attention blocks, then enc_norm."""
    x = frames + L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                        device=frames.device).to(frames.dtype)[None]
    attend = lambda p, xin: (attn_lib.attention_encoder(p, xin, cfg), None)
    for i, bp in enumerate(params["encoder"]):
        x = _remat(lambda x, bp=bp, i=i: _attn_block(bp, x, cfg, attend, i, shard=shard)[0],
                   remat)(x)
    return L.apply_norm(params["enc_norm"], x, cfg.norm_eps)


def _serving(shard: ShardingHints) -> ShardingHints:
    """The hints a serving pass takes: the JAX package's prefill and decode
    run the MoE layer without weight specs or expert parallelism."""
    return dataclasses.replace(shard, moe_w_in=None, moe_w_out=None, moe_ep=None)


def prefill(params, cfg: ArchConfig, batch, cache, *, shard: ShardingHints = NO_HINTS):
    """Run the prompt through the model in one pass; returns the last
    token's logits (B, V) in float32 and the filled cache (in place).
    ``batch`` holds ``tokens`` (B, S) and, for whisper, ``frames`` (B, Se,
    d); for qwen2-vl optionally ``patches`` (B, Pn, frontend_dim)."""
    shard = _serving(shard)
    tokens = batch["tokens"]
    with span("model.embed"):
        x, positions_thw = _embed_inputs(params, cfg, batch, shard)
    cross = None
    if cfg.encoder_layers:
        enc_out = _encoder_forward(params, cfg, batch["frames"].to(x.dtype), shard=shard)

        def cross(p, xin, ck, cv):
            # the layer's cross K/V, projected once: they fill its cache
            # slots and feed this prompt's cross-attention
            k, v = attn_lib.project_kv(p, enc_out, cfg)
            ck.copy_(k)
            cv.copy_(v)
            return attn_lib.cross_attention_prefill(p, xin, cfg, k, v)
    # every attention block rotates at the prompt's positions: one table a pass
    table = None if cfg.attention_free else attn_lib.prompt_table(
        cfg, *tokens.shape, x.device, positions_thw)
    attend = attn_lib.mla_prefill if cfg.mla else attn_lib.attention_prefill
    x = _run_blocks(params, cfg, x, cache,
                    lambda p, xin, lc: attend(p, xin, cfg, lc, table=table),
                    ssm_lib.mamba2_prefill, _rwkv_prefill, cross, shard)
    cache.update(prefill_host_fields(cfg, batch))
    with span("model.head"):
        return _logits(params, cfg, x[:, -1, :]), cache


def decode_step(params, cfg: ArchConfig, token, cache, *, shard: ShardingHints = NO_HINTS):
    """token: (B, 1) int -> (logits (B, 1, V) float32, cache updated in place);
    of the hints only the logits' applies, as in the JAX package."""
    with span("model.embed"):
        x = _embed(params, cfg, token)
        if cfg.family == "encdec":        # whisper: the sinusoidal table's row at this step
            x = x + L.sinusoidal_positions(1, cfg.d_model, cache["step"],
                                           x.device).to(x.dtype)
    positions_thw = None
    if cfg.m_rope:      # qwen2-vl rotates at step + mrope_delta; the KV cache keeps cache.pos
        pos = torch.full((token.shape[0], 1), cache["step"] + cache["mrope_delta"],
                         dtype=torch.int32, device=x.device)
        positions_thw = rope_lib.text_positions_thw(pos)
    cross = None
    if cfg.encoder_layers:
        cross = lambda p, xin, k, v: attn_lib.cross_attention_decode(p, xin, cfg, k, v)
    x = _run_blocks(params, cfg, x, cache,
                    (lambda p, xin, lc: attn_lib.mla_decode(p, xin, cfg, lc)) if cfg.mla else
                    lambda p, xin, lc: attn_lib.attention_decode(
                        p, xin, cfg, lc, positions_thw=positions_thw),
                    ssm_lib.mamba2_decode, _rwkv_decode, cross)
    cache["step"] += 1
    with span("model.head"):
        return _logits(params, cfg, x, shard), cache


# ---------------------------------------------------------------------------
# Full-sequence forward and the training loss
# ---------------------------------------------------------------------------

def _train_attn_block(bp, x, cfg: ArchConfig, positions_thw=None, enc_out=None, layer: int = 0,
                      shard: ShardingHints = NO_HINTS):
    """Causal self-attention (the model's window), whisper's cross-attention
    to ``enc_out``, then the MLP or MoE layer -> (x, aux or None)."""
    attend = lambda p, xin: (attn_lib.attention_forward(p, xin, cfg,
                                                        positions_thw=positions_thw), None)
    cross = None
    if enc_out is not None:
        cross = lambda p, xin: attn_lib.attention_forward(p, xin, cfg, x_kv=enc_out)
    return _attn_block(bp, x, cfg, attend, layer, cross, shard)


def _rwkv_block_fwd(bp, x, cfg: ArchConfig, shard: ShardingHints = NO_HINTS):
    h, _ = rwkv_lib.time_mix(bp["rwkv"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg)
    x = _c(x + h, shard.residual, shard)
    h, _ = rwkv_lib.channel_mix(bp["rwkv"], L.apply_norm(bp["ln2"], x, cfg.norm_eps), cfg)
    return _c(x + h, shard.residual, shard)


def _mamba_block_fwd(bp, x, cfg: ArchConfig, layer: int = 0, shard: ShardingHints = NO_HINTS):
    h = ssm_lib.apply_mamba2(bp["mamba"], L.apply_norm(bp["ln1"], x, cfg.norm_eps), cfg)
    x = _c(x + _branch(cfg, h), shard.residual, shard)
    return _attn_ffn(bp, x, cfg, layer, shard)[0] if cfg.mamba_ffn else x


def forward(params, cfg: ArchConfig, batch, *, remat: bool = False,
            shard: ShardingHints = NO_HINTS):
    """Full-sequence decoder forward -> (final-normed hidden (B, S, d), MoE
    aux loss summed over layers, float32).  ``batch`` holds ``tokens`` and,
    for whisper, ``frames``; for qwen2-vl optionally ``patches``.  With
    ``remat`` each block (each zamba2 group, and each Mamba2 layer inside
    it) is recomputed in the backward instead of keeping its activations,
    as the JAX package's ``jax.checkpoint`` sites do.  MLA serves only: it
    raises NotImplementedError."""
    check_supported(cfg)
    if cfg.mla:
        raise NotImplementedError(f"{cfg.name}: training does not run multi-head latent "
                                  "attention (MLA); it serves through prefill and decode_step")
    x, positions_thw = _embed_inputs(params, cfg, batch, shard)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    every = cfg.shared_attn_every
    if every:          # zamba2: [shared attention + k Mamba2 layers] groups
        def group(x, g):
            x, _ = _train_attn_block(params["shared_attn"], x, cfg, shard=shard)
            for bp in params["blocks"][g * every:(g + 1) * every]:
                x = _remat(lambda x, bp=bp: _mamba_block_fwd(bp, x, cfg, shard=shard), remat)(x)
            return x
        for g in range(_groups(cfg)):
            x = _remat(lambda x, g=g: group(x, g), remat)(x)
        return L.apply_norm(params["final_norm"], x, cfg.norm_eps), aux
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encoder_forward(params, cfg, batch["frames"].to(x.dtype), remat, shard)
    for i, (kind, bp) in enumerate(zip(cfg.pattern, params["blocks"])):
        if kind == "attn":
            x, a = _remat(lambda x, bp=bp, i=i: _train_attn_block(
                bp, x, cfg, positions_thw, enc_out, i, shard), remat)(x)
            if a is not None:
                aux = aux + a
        elif kind == "rwkv6":
            x = _remat(lambda x, bp=bp: _rwkv_block_fwd(bp, x, cfg, shard), remat)(x)
        else:
            x = _remat(lambda x, bp=bp, i=i: _mamba_block_fwd(bp, x, cfg, i, shard), remat)(x)
    return L.apply_norm(params["final_norm"], x, cfg.norm_eps), aux


def train_loss(params, cfg: ArchConfig, batch, *, remat: bool = True,
               shard: ShardingHints = NO_HINTS):
    """Mean next-token cross-entropy (float32) plus the MoE aux loss; the
    unembedding is the tied table or ``head["w"].T``."""
    hidden, aux = forward(params, cfg, batch, remat=remat, shard=shard)
    table = params["embed"]["table"] if cfg.tie_embeddings else params["head"]["w"].T
    hint = (lambda t: _c(t, shard.logits, shard)) if shard.logits is not None else None
    return L.chunked_cross_entropy(hidden, table, batch["labels"], constrain_logits=hint) + aux
