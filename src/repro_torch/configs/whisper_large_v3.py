"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.

32 decoder layers (and 32 encoder layers per the model card), d_model=1280,
20 heads (GQA kv=20, i.e. MHA), d_ff=5120, vocab=51866.  The mel-spectrogram
+ conv feature extractor frontend is a STUB per the brief: ``input_specs``
feeds precomputed 1280-d frame embeddings.  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    source="arXiv:2212.04356",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq_len=1500,
    cross_attention=True,
    frontend="audio",
    act_fn="gelu",
    rope_theta=0.0,        # whisper uses learned/sinusoidal abs positions
    qkv_bias=True,
)
