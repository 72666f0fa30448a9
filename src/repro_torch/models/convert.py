"""Share weights with the JAX package.

``params_from_jax`` takes the JAX parameter tree after
``jax.tree.map(np.asarray, params)`` and returns the port's tree: the same
nested dicts and leaf layouts, with the stacked leading layer axis of
``params["blocks"]`` split into one dict per layer (attention, RWKV6 or
Mamba2 blocks alike); every other entry, zamba2's unstacked
``shared_attn`` block among them, is copied as it is.  Values are copied
exactly: a float32 leaf stays bit-for-bit the same float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import check_supported


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params, cfg: ArchConfig, device):
    """JAX tree of numpy arrays -> the port's parameter tree on ``device``."""
    check_supported(cfg)
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in np_params.items() if k != "blocks"}
    out["blocks"] = [_map(np_params["blocks"], lambda a, i=i: _tensor(a[i], device))
                     for i in range(cfg.n_layers)]
    return out
