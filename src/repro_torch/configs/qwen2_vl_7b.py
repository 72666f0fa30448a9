"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution.

28L, d_model=3584, 28H (GQA kv=4), d_ff=18944, vocab=152064.  The ViT
vision encoder + projector is a STUB per the brief: ``input_specs`` feeds
precomputed patch embeddings.  [arXiv:2409.12191]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    m_rope=True,
    m_rope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
    vision_patches=256,
    frontend_dim=1280,     # ViT output dim before projector
)
