"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L, d_model=2048, d_ff=7168, vocab=65536. [arXiv:2404.05892]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / 64 time-mix heads
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    rwkv_head_dim=64,
)
