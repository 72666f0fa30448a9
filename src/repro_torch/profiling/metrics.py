"""Workload characteristics of the served models.

Bridges the JAX model zoo and the iGniter provisioning study: every
served model gets a `ServedModelDesc` whose FLOPs / bytes / kernel-count
/ IO sizes are derived from the *actual architecture configs* (analytic
formulas cross-checked against ``compiled.cost_analysis()`` in tests).
These feed the ground-truth simulator physics AND the (separately fitted)
iGniter coefficients — the simulator adds contention/noise on top, so the
model-vs-measurement comparison stays honest.

A copy of the JAX package's ``repro.profiling.metrics`` over the port's
copy of the config registry: the numbers are formulas of the configs and
need no framework.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ServedModelDesc:
    """One inference 'query' type: a model + fixed request shape.

    A request item = prefill of `prompt_len` tokens (plus modality
    embeddings) producing one scored continuation token — the LLM-serving
    analogue of the paper's single CNN inference.
    """
    name: str
    arch: str
    prompt_len: int
    # derived:
    flops_per_item: float       # forward FLOPs for one request item
    weight_bytes: float         # bytes of (active) weights read per pass
    act_bytes_per_item: float   # activation traffic per item
    n_kernels: int              # fused-computation count per pass
    d_load_mb: float            # host->HBM input MB per item
    d_feedback_mb: float        # HBM->host output MB per item


def _attn_flops(cfg: ArchConfig, s: int) -> float:
    # projections + scores + values, per token
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * cfg.d_model * (H * hd + 2 * KV * hd) + 2 * (H * hd) * cfg.d_model
    win = min(s, cfg.sliding_window or s)
    scores = 2 * 2 * H * hd * win            # q.k and attn.v per token (avg)
    return proj + scores


def _block_flops_per_token(cfg: ArchConfig, kind: str, s: int) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    if kind == "attn":
        mlp = (6 if cfg.act_fn == "silu" else 4) * d * ff
        if cfg.is_moe:
            mlp *= cfg.top_k
            mlp += 2 * d * cfg.n_experts          # router
        return _attn_flops(cfg, s) + mlp
    if kind == "mamba2":
        d_in = cfg.ssm_expand * d
        H = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
        N = cfg.ssm_state
        proj = 2 * d * (2 * d_in + 2 * N + H) + 2 * d_in * d
        ssd = 2 * d_in * N * 2                     # state update + readout
        return proj + ssd
    if kind == "rwkv6":
        tm = 2 * 6 * d * d
        state = 2 * 2 * d * cfg.rwkv_head_dim      # (hd,hd) per-head update
        cm = 2 * 2 * d * ff
        return tm + state + cm
    raise ValueError(kind)


def forward_flops(cfg: ArchConfig, tokens: int, seq: int,
                  enc_frames: Optional[int] = None) -> float:
    """Total forward FLOPs for `tokens` tokens at context length `seq`."""
    per_tok = 0.0
    for kind in cfg.pattern:
        per_tok += _block_flops_per_token(cfg, kind, seq)
    if cfg.shared_attn_every:
        n_app = (cfg.n_layers + cfg.shared_attn_every - 1) // cfg.shared_attn_every
        per_tok += n_app * (_attn_flops(cfg, seq)
                            + (6 if cfg.act_fn == "silu" else 4)
                            * cfg.d_model * cfg.d_ff)
    head = 2 * cfg.d_model * cfg.vocab_size
    total = (per_tok + head / max(seq, 1)) * tokens
    if cfg.encoder_layers:
        frames = enc_frames if enc_frames is not None else cfg.encoder_seq_len
        enc_per_tok = cfg.encoder_layers * (
            _attn_flops(cfg, frames) + 4 * cfg.d_model * cfg.d_ff)
        total += enc_per_tok * frames * (tokens / max(seq, 1))
    return total


def kernel_count(cfg: ArchConfig) -> int:
    """Fused-computation count per serving pass (XLA ~fuses each block into
    a handful of kernels; cross-checked against compiled HLO in tests)."""
    per_block = {"attn": 14 if not cfg.is_moe else 22, "mamba2": 16,
                 "rwkv6": 18}
    n = sum(per_block[k] for k in cfg.pattern)
    if cfg.shared_attn_every:
        n += 14 * ((cfg.n_layers + cfg.shared_attn_every - 1)
                   // cfg.shared_attn_every)
    if cfg.encoder_layers:
        n += 12 * cfg.encoder_layers
    return n + 12   # embed/head/norm/io


def make_served_desc(name: str, arch: str, prompt_len: int,
                     enc_frames: Optional[int] = None) -> ServedModelDesc:
    cfg = get_config(arch)
    flops = forward_flops(cfg, prompt_len, prompt_len, enc_frames)
    active = cfg.n_active_params()
    weight_bytes = 2.0 * active                       # bf16 weights per pass
    act_bytes = 2.0 * prompt_len * cfg.d_model * (len(cfg.pattern) * 4)
    d_load = prompt_len * 4 / 1e6                     # token ids
    if cfg.frontend == "audio":
        frames = enc_frames if enc_frames is not None else cfg.encoder_seq_len
        d_load += frames * cfg.d_model * 2 / 1e6
    if cfg.frontend == "vision":
        fd = cfg.frontend_dim or cfg.d_model
        d_load += cfg.vision_patches * fd * 2 / 1e6
    d_feedback = 8 * 4 / 1e6 + 32 * 4 / 1e6           # token + top-k logprobs
    return ServedModelDesc(
        name=name, arch=arch, prompt_len=prompt_len,
        flops_per_item=flops, weight_bytes=weight_bytes,
        act_bytes_per_item=act_bytes, n_kernels=kernel_count(cfg),
        d_load_mb=d_load, d_feedback_mb=d_feedback,
    )


# The serving-study model zoo (4 heterogeneous models, paper Table 3 analogue)
SERVING_MODELS: Dict[str, ServedModelDesc] = {}


def serving_models() -> Dict[str, ServedModelDesc]:
    global SERVING_MODELS
    if not SERVING_MODELS:
        SERVING_MODELS = {
            "rwkv6-1.6b": make_served_desc("rwkv6-1.6b", "rwkv6-1.6b", 64),
            "qwen1.5-4b": make_served_desc("qwen1.5-4b", "qwen1.5-4b", 64),
            "qwen2-vl-7b": make_served_desc("qwen2-vl-7b", "qwen2-vl-7b", 32),
            "whisper-large-v3": make_served_desc(
                "whisper-large-v3", "whisper-large-v3", 16, enc_frames=300),
        }
    return SERVING_MODELS
