"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L, d_model=2560, 32H (GQA kv=32), d_ff=10240, ssm_state=64.  One
weight-tied attention(+MLP) block is applied every 6 Mamba2 layers per the
Zamba2 design. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2",),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    # at 500k decode the shared attn block runs sliding-window (see DESIGN.md)
    sliding_window=None,
)
