"""Shared set-up of the DeepSeek-V2 tests (tests/test_torch_mla*.py): a
small configuration (a dense layer, then 2 MoE layers of 8 experts,
top-2, un-renormalised gates; YaRN over 16 rope columns at an original
context of 256, so the ramp between its bands acts), seeded weights with
every vector perturbed, and the benchmark's plain reference
(``perfbench/reference/deepseek_mla.py``), which imports nothing of the
port."""
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.models import rope
from repro_torch.models.zoo import build_model

REF_DIR = Path(__file__).resolve().parents[1] / "perfbench" / "reference"
if str(REF_DIR) not in sys.path:
    sys.path.insert(0, str(REF_DIR))

import deepseek_mla as reference  # noqa: E402
from ref_common import Precision  # noqa: E402

F32 = Precision("float32")
SIZE_KEYS = ("n_layers", "d_model", "n_heads", "qk_nope_head_dim", "qk_rope_head_dim",
             "v_head_dim", "kv_lora_rank", "d_ff", "dense_d_ff", "first_dense_layers",
             "n_experts", "top_k", "norm_topk", "shared_expert_ff", "vocab_size", "norm_eps",
             "rope_theta", "rope_factor", "rope_original_max", "yarn_mscale_all_dim")


def small_cfg(**kw):
    """deepseek-v2-lite's block at small widths."""
    return get_config("deepseek-v2-lite").replace(**{
        "n_layers": 3, "d_model": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 48,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32, "kv_lora_rank": 64,
        "d_ff": 64, "dense_d_ff": 256, "n_experts": 8, "top_k": 2, "shared_expert_ff": 128,
        "vocab_size": 256, "rope_original_max": 256, "dtype": "float32", **kw})


def small_model(seed=0, **kw):
    """(model, params): the port's init with every vector (norm scales, the
    latent's norm) moved off its init by N(0, 0.1)."""
    cfg = small_cfg(**kw)
    model = build_model(cfg, "cpu")
    params = model.init(seed)
    g = torch.Generator().manual_seed(seed + 1)

    def perturb(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                perturb(v)
        elif isinstance(tree, list):
            for v in tree:
                perturb(v)
        elif tree.dim() == 1:
            tree.add_(0.1 * torch.randn(tree.shape, generator=g))
    perturb(params)
    return model, params


def sizes(cfg):
    """The reference's sizes of a configuration."""
    return {**{k: getattr(cfg, k) for k in SIZE_KEYS}, "head_dim": cfg.hd,
            "yarn_beta_fast": rope.YARN_BETA_FAST, "yarn_beta_slow": rope.YARN_BETA_SLOW}


def reference_logits(params, cfg, tokens):
    """(b, S, V) logits of the plain reference at every position."""
    with torch.inference_mode():
        return reference.head(params, reference.hidden(params, sizes(cfg), tokens, F32), F32)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())
