"""qwen3-4b [dense] — qk_norm, GQA.

36L, d_model=2560, 32H (GQA kv=8), d_ff=9728, vocab=151936. [hf:Qwen/Qwen3-8B]

``long_500k`` for this arch uses the beyond-paper sliding-window variant
(``CONFIG_SWA``); the faithful full-attention CONFIG is used elsewhere.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

# Beyond-paper block-sparse/sliding-window variant (unlocks long_500k).
CONFIG_SWA = CONFIG.replace(name="qwen3-4b-swa", sliding_window=4096)
