"""DeepSeek-V2-Lite [moe] — multi-head latent attention and DeepSeekMoE.

27L, d_model=2048, 16 heads, vocabulary 102400, RMSNorm eps 1e-6, SiLU,
no attention bias, untied head.  Attention is MLA without a q projection
through a latent: q = h W_q (16 heads of 128 unrotated + 64 rotated
columns); [c | k_pe] = h W_kva (512 + 64), c RMSNorm'd; [k_nope | v] =
c W_kvb (16 x (128 + 128)); k_pe, one 64-wide rotated vector, is shared
by every head, so a head's q.k runs over 192 columns and its v over 128.
The rotation is YaRN (theta 1e4, factor 40 over an original 4096
positions, beta_fast 32, beta_slow 1: ``rope.yarn_freqs``'s constants) on
consecutive pairs of the 64 rope columns; the softmax scale is 192^-0.5 ·
m(40, 0.707)^2, m(f, s) = 0.1 s ln f + 1 (DeepSeek's code, vLLM and
transformers' deepseek_v3), the table unscaled (mscale equals
mscale_all_dim: m(40, 0.707) / m(40, 0.707) = 1).  Layer 0's FFN is a dense
SwiGLU of 10944; layers 1-26 are DeepSeekMoE: a float32 softmax router
over 64 experts, greedy top-6, gates not renormalised (routed scaling 1: none),
each expert a SwiGLU of 1408, and 2 shared experts as one SwiGLU of 2816
added to the routed sum.  15.7 B parameters, 2.4 B active.
[hf:deepseek-ai/DeepSeek-V2-Lite, config.json, model_type deepseek_v2]
"""
from repro_torch.configs.base import MLAConfig

CONFIG = MLAConfig(
    name="deepseek-v2-lite",
    family="moe",
    source="hf:deepseek-ai/DeepSeek-V2-Lite",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10000.0,
    n_experts=64,
    top_k=6,
    moe_dropless=True,
    shared_expert_ff=2816,
    norm_eps=1e-6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_factor=40.0,
    rope_original_max=4096,
    yarn_mscale_all_dim=0.707,
    first_dense_layers=1,
    dense_d_ff=10944,
    norm_topk=False,
)
