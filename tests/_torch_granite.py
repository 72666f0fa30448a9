"""Shared set-up of the granite-4.0-h tests (tests/test_torch_granite*.py):
a small configuration with both layer kinds, seeded weights with every
vector perturbed, and the benchmark's plain reference
(``perfbench/reference/granite_hybrid.py``), which imports nothing of the
port."""
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.models.zoo import build_model

REF_DIR = Path(__file__).resolve().parents[1] / "perfbench" / "reference"
if str(REF_DIR) not in sys.path:
    sys.path.insert(0, str(REF_DIR))

import granite_hybrid as reference  # noqa: E402
from ref_common import Precision  # noqa: E402

PATTERN = ("mamba2", "attn", "mamba2", "mamba2", "attn")
F32 = Precision("float32")


def small_cfg(**kw):
    """granite-4.0-h-small's block at small widths: 5 layers of both kinds,
    8 experts (top-3), a shared expert, state 16."""
    return get_config("granite-4.0-h-small").replace(**{
        "n_layers": len(PATTERN), "block_pattern": PATTERN, "d_model": 128, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 32, "d_ff": 64, "vocab_size": 256, "n_experts": 8,
        "top_k": 3, "experts_held": 0, "shared_expert_ff": 96, "ssm_state": 16,
        "ssm_heads": 8, "ssm_head_dim": 32, "dtype": "float32", **kw})


def small_model(seed=0, **kw):
    """(model, params): the port's init with every vector (norm scales,
    conv bias, D) moved off its init by N(0, 0.1), A_log and dt_bias kept."""
    cfg = small_cfg(**kw)
    model = build_model(cfg, "cpu")
    params = model.init(seed)
    g = torch.Generator().manual_seed(seed + 1)

    def perturb(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                perturb(v, f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                perturb(v, f"{path}.{i}")
        elif tree.dim() == 1 and not path.endswith(("A_log", "dt_bias")):
            tree.add_(0.1 * torch.randn(tree.shape, generator=g))
    perturb(params)
    return model, params


def sizes(cfg):
    """The reference's sizes of a configuration."""
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "n_experts",
            "top_k", "shared_expert_ff", "ssm_state", "ssm_heads", "ssm_head_dim",
            "ssm_expand", "d_conv", "norm_eps", "embedding_multiplier",
            "residual_multiplier", "attention_multiplier", "logits_scaling")
    return {**{k: getattr(cfg, k) for k in keys}, "head_dim": cfg.hd,
            "experts_held": cfg.n_held, "attn_layers": cfg.attn_layers}


def reference_logits(params, cfg, tokens):
    """(b, S, V) logits of the plain reference at every position."""
    with torch.inference_mode():
        h = reference.hidden(params, sizes(cfg), tokens, F32)
        return reference.head(params, h, F32)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())
