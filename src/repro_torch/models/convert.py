"""Share weights with the JAX package.

``params_from_jax`` takes the JAX parameter tree after
``jax.tree.map(np.asarray, params)`` and returns the port's tree: the same
nested dicts and leaf layouts, with the stacked leading layer axis of
``params["blocks"]`` and of whisper's ``params["encoder"]`` split into
one dict per layer (attention blocks with a SwiGLU or GELU MLP, with MoE
experts or with whisper's cross-attention, RWKV6 or Mamba2 blocks alike;
an MoE block's experts keep their virtual-expert axis); every other
entry, zamba2's unstacked ``shared_attn`` block, whisper's ``enc_norm``
and qwen2-vl's ``vis_proj`` among them, is copied as it is.  Values are copied
exactly: a float32 leaf stays bit-for-bit the same float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import check_supported
from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_params, cfg: ArchConfig, device):
    """JAX tree of numpy arrays -> the port's parameter tree on ``device``."""
    check_supported(cfg)
    stacked = {"blocks": cfg.n_layers, "encoder": cfg.encoder_layers}
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in np_params.items() if k not in stacked}
    for key, n in stacked.items():
        if key in np_params:
            out[key] = [tree_map(lambda a, i=i: _tensor(a[i], device), np_params[key])
                        for i in range(n)]
    return out
