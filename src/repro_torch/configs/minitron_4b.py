"""minitron-4b [dense] — pruned nemotron decoder.

32L, d_model=3072, 24H (GQA kv=8), d_ff=9216, vocab=256000. [arXiv:2407.14679]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    act_fn="gelu",        # nemotron uses squared-relu; gelu family stands in
    rope_theta=10_000.0,
)
