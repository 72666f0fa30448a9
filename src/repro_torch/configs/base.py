"""Architecture configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the model zoo
(`repro_torch.models.zoo`) builds a concrete PyTorch model from it.
Configs carry citations to their source paper / model card in ``source``.
``ArchConfig`` is a verbatim copy of the JAX package's config system, so
both packages read the same architectures.  ``GraniteConfig`` (below) is
the port's own: it adds the fields granite-4.0-h needs (a held share of
the experts, the dropless MoE with a shared expert, and the muP
multipliers); ``MLAConfig`` adds DeepSeek-V2's (multi-head latent
attention, YaRN rotation, leading dense layers, un-renormalised gates).
``ArchConfig`` reads each of them as a class default, the behaviour every
other configuration has.

Block kinds (``block_pattern`` entries):
  "attn"    -- self-attention + MLP (dense or MoE depending on n_experts)
  "mamba2"  -- Mamba2 / SSD block (used by zamba2, standalone ssm archs)
  "rwkv6"   -- RWKV6 time-mix + channel-mix block
A hybrid arch interleaves kinds via ``block_pattern``; homogeneous archs
use a single entry that is repeated ``n_layers`` times.  In a pattern that
mixes "attn" and "mamba2" (granite-4.0-h) every layer is its mixer and
then its FFN; zamba2's Mamba2 blocks, a uniform pattern, have no FFN.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ------------------------------------------------------
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    source: str                     # citation (arXiv id / model card)

    # -- transformer backbone ------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # -- block layout ---------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)

    # -- attention details ----------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # None = full causal attention
    rope_theta: float = 10_000.0
    m_rope: bool = False                   # Qwen2-VL multimodal RoPE
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2

    # -- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # virtual-expert F-split: store expert FFNs as (E*ks, D, F/ks) so E*ks
    # matches a mesh axis for expert parallelism (SwiGLU decomposes exactly
    # over F).  1 = off.
    expert_shards: int = 1

    # -- SSM (Mamba2 / SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0             # number of SSD heads (0 -> derived)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4

    # -- RWKV6 -------------------------------------------------------------
    rwkv_head_dim: int = 64

    # -- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq_len: int = 1500    # whisper: 30 s of audio at 50 Hz
    cross_attention: bool = False

    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0     # apply the weight-tied shared attn block every k layers

    # -- GraniteConfig's fields, as every other configuration has them:
    # class defaults, not fields, so that the fields stay the JAX package's
    experts_held = 0
    moe_dropless = False
    shared_expert_ff = 0
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    attention_multiplier = None
    logits_scaling = 1.0
    # -- MLAConfig's, likewise
    kv_lora_rank = 0
    qk_nope_head_dim = 0
    qk_rope_head_dim = 0
    v_head_dim = 0
    rope_factor = 1.0
    rope_original_max = 0
    yarn_mscale_all_dim = 0.0
    first_dense_layers = 0
    dense_d_ff = 0
    norm_topk = True

    # -- modality frontend (STUB per brief: precomputed embeddings) ----------
    frontend: Optional[str] = None   # None | "audio" | "vision"
    vision_patches: int = 256        # patches prepended for the VLM stub
    frontend_dim: int = 0            # raw embedding dim fed by the stub (0 = d_model)

    # -- misc -------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act_fn: str = "silu"            # silu (swiglu) | gelu (plain 2-layer MLP)
    dtype: str = "bfloat16"
    # use Pallas kernels for attention/scan hot spots (CPU tests keep False)
    use_pallas: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def mla(self) -> bool:
        """Multi-head latent attention (DeepSeek-V2) in every attention layer."""
        return self.kv_lora_rank > 0

    @property
    def yarn(self) -> Optional[Tuple[float, int]]:
        """YaRN's (factor, original context), or None for plain RoPE."""
        if self.rope_factor == 1.0:
            return None
        return (self.rope_factor, self.rope_original_max)

    def is_dense_layer(self, layer: int) -> bool:
        """A layer whose FFN is a dense MLP: every layer of a model without
        experts, and an MoE model's first ``first_dense_layers``."""
        return not self.is_moe or layer < self.first_dense_layers

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == n_layers."""
        if len(self.block_pattern) == self.n_layers:
            return self.block_pattern
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def n_held(self) -> int:
        """Experts of each MoE layer whose weights this card holds."""
        return self.experts_held or self.n_experts

    @property
    def mamba_ffn(self) -> bool:
        """A pattern mixing Mamba2 and attention layers: each Mamba2 layer
        carries an FFN after its mixer, as each attention layer does."""
        return "mamba2" in self.pattern and "attn" in self.pattern

    @property
    def attn_layers(self) -> list:
        """Indices of the attention layers."""
        return [i for i, k in enumerate(self.pattern) if k == "attn"]

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba2", "rwkv6") for k in self.pattern) and self.shared_attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S) full-attn KV?"""
        if self.attention_free:
            return True
        if self.shared_attn_every > 0:
            # hybrid: shared attn block runs windowed at long context
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d          # wq, wk, wv, wo
        if self.qkv_bias:
            attn += q + 2 * kv
        if self.mla:      # wq, wkv_a, the latent's norm, wkv_b, wo
            H, r = self.n_heads, self.qk_rope_head_dim
            attn = (d * H * hd + d * (self.kv_lora_rank + r) + self.kv_lora_rank
                    + self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                    + H * self.v_head_dim * d)
        mlp_dense = (3 if self.act_fn == "silu" else 2) * d * ff
        mlp_moe = self.n_held * mlp_dense + d * self.n_experts + 3 * d * self.shared_expert_ff
        ffn = mlp_moe if self.is_moe else mlp_dense
        n = V * d                                   # token embedding
        if not self.tie_embeddings:
            n += V * d                              # lm head
        for i, kind in enumerate(self.pattern):
            if kind == "attn":
                n += attn + (3 * d * self.dense_d_ff if i < self.first_dense_layers else ffn)
                n += 2 * d                          # two rmsnorm scales
            elif kind == "mamba2":
                d_in = self.ssm_expand * d
                heads = self.ssm_heads or (d_in // self.ssm_head_dim)
                n += d * (2 * d_in + 2 * heads * self.ssm_state + heads)  # in/x/B/C/dt proj
                n += d_in * self.d_conv + d_in      # conv + bias
                n += d_in * d + d                   # out proj + norm
                if self.mamba_ffn:
                    n += ffn + d                    # the FFN and its norm
            elif kind == "rwkv6":
                # time-mix: r,k,v,g,w projections + output, channel-mix: 2 mats
                n += 6 * d * d + 2 * d * ff + 2 * d
        if self.shared_attn_every:
            n += attn + mlp_dense                   # one shared, weight-tied block
        if self.encoder_layers:
            n += self.encoder_layers * (attn + mlp_dense + 2 * d)
            # decoder cross-attention per layer
            n += self.n_layers * (attn + 2 * d)
        if self.frontend == "vision":
            n += (self.frontend_dim or d) * d       # projector
        return n

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        per_expert = 3 * d * ff
        moe_layers = (self.n_layers if self.mamba_ffn else self.pattern.count("attn")) \
            - self.first_dense_layers
        inactive = (self.n_held - self.top_k * self.n_held // self.n_experts) * per_expert
        return self.n_params() - inactive * moe_layers


@dataclass(frozen=True)
class GraniteConfig(ArchConfig):
    """An ``ArchConfig`` with the port's own fields, which granite-4.0-h
    needs; each default is ``ArchConfig``'s class default."""
    # experts this card holds of each MoE layer (experts 0 .. experts_held - 1;
    # the router keeps all n_experts outputs); 0 = all of them
    experts_held: int = 0
    moe_dropless: bool = False     # every assignment to a held expert computed, none dropped
    shared_expert_ff: int = 0      # width of a shared SwiGLU expert beside the routed ones
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0   # on every mixer's and FFN's output before the add
    attention_multiplier: Optional[float] = None   # score scale; None = 1 / sqrt(head_dim)
    logits_scaling: float = 1.0        # logits divided by it


@dataclass(frozen=True)
class MLAConfig(GraniteConfig):
    """A ``GraniteConfig`` with DeepSeek-V2's fields; each default is
    ``ArchConfig``'s class default.  ``head_dim`` is the q.k width,
    qk_nope_head_dim + qk_rope_head_dim."""
    kv_lora_rank: int = 0          # the latent c's width; 0 = no MLA
    qk_nope_head_dim: int = 0      # a head's unrotated q / k columns
    qk_rope_head_dim: int = 0      # its rotated ones (k's shared by every head)
    v_head_dim: int = 0            # a head's value width
    rope_factor: float = 1.0       # YaRN's scale; 1 = plain RoPE
    rope_original_max: int = 0     # YaRN's original context
    yarn_mscale_all_dim: float = 0.0   # the softmax scale's m(f, all_dim)^2; 0 = none
    first_dense_layers: int = 0    # leading layers with a dense MLP of dense_d_ff
    dense_d_ff: int = 0
    norm_topk: bool = True         # gates renormalised over the top k, else the probabilities


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ArchConfig:
    """CPU-smoke-test variant of the same family (per brief: 2 layers,
    d_model<=512, <=4 experts)."""
    hd = 32
    n_heads = max(2, d_model // 64)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep the GQA ratio flavor
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // max(1, cfg.n_heads // cfg.n_kv_heads))
    else:
        n_kv = n_heads
    pat = cfg.block_pattern
    kw = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=2 * d_model,
        vocab_size=vocab,
        block_pattern=pat if len(pat) <= layers else pat[:layers],
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        expert_shards=1,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state or "mamba2" in pat or "rwkv6" in pat else cfg.ssm_head_dim,
        rwkv_head_dim=32,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 32),
        shared_attn_every=min(cfg.shared_attn_every, 2) if cfg.shared_attn_every else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
        vision_patches=min(cfg.vision_patches, 8),
        m_rope_sections=(hd // 2 - 2 * (3 * hd // 16), 3 * hd // 16, 3 * hd // 16)
        if cfg.m_rope else cfg.m_rope_sections,
        frontend_dim=min(cfg.frontend_dim, d_model) if cfg.frontend_dim else 0,
        dtype="float32",
    )
    if cfg.mla:     # the q.k width split in half, a latent of 2 heads' width
        kw.update(qk_nope_head_dim=hd // 2, qk_rope_head_dim=hd // 2, v_head_dim=hd,
                  kv_lora_rank=2 * hd, dense_d_ff=2 * d_model,
                  shared_expert_ff=min(cfg.shared_expert_ff, 2 * d_model))
    return cfg.replace(**kw)
