"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.

40L, d_model=6144, 48H (GQA kv=8), d_ff=10752, vocab=100352.
[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    qk_norm=False,
    rope_theta=500_000.0,
)
