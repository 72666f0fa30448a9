"""qwen1.5-4b [dense] — QKV-bias llama-style decoder.

40L, d_model=2560, 20H (GQA kv=20, i.e. MHA), d_ff=6912, vocab=151936.
[hf:Qwen/Qwen1.5-0.5B family]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
