"""granite-4.0-h-small [hybrid] — Mamba2 + NoPE GQA layers, each followed by a
dropless MoE of 72 SwiGLU experts (top-10) and a shared expert.

40L, d_model=4096: 36 Mamba2 layers (128 heads of 64, d_state 128, one
group, conv 4 with a bias, gated RMSNorm) and 4 attention layers at 5, 15,
25 and 35 (32 query / 8 KV heads of 128, no position embedding, scores
scaled by attention_multiplier = 1/128).  Every layer's FFN: 72 experts of
width 768, top-10, softmax over the chosen logits (the port's softmax then
renormalisation), plus a shared SwiGLU expert of width 1536.  muP: the
embedding times 12, each residual branch times 0.22, the logits over 16.
Tied embeddings, vocabulary 100352.
[hf:ibm-granite/granite-4.0-h-small, config.json, model_type granitemoehybrid]

``rope_theta`` is 0 here (no rotation): the published config gives
``rope_theta: 10000`` beside ``position_embedding_type: "nope"``, and the
attention layers rotate nothing.  The config holds all 72 experts; a card
of an expert-parallel group takes ``.replace(experts_held=...)``.
"""
from repro_torch.configs.base import GraniteConfig

N_LAYERS = 40
ATTN_LAYERS = (5, 15, 25, 35)

CONFIG = GraniteConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    source="hf:ibm-granite/granite-4.0-h-small",
    n_layers=N_LAYERS,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    block_pattern=tuple("attn" if i in ATTN_LAYERS else "mamba2" for i in range(N_LAYERS)),
    rope_theta=0.0,
    n_experts=72,
    top_k=10,
    moe_dropless=True,
    shared_expert_ff=1536,
    ssm_state=128,
    ssm_heads=128,
    ssm_head_dim=64,
    ssm_expand=2,
    d_conv=4,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    tie_embeddings=True,
    norm_eps=1e-5,
)
