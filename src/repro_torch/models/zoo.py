"""Model zoo: a uniform Model facade over the transformer assembly.

Counterpart of the JAX package's ``models/zoo.py`` for the serving path.
A ``Model`` is bound to a device; ``init(seed)`` draws its weights from a
``torch.Generator`` on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    # -- params ---------------------------------------------------------
    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return T.init_params(self.cfg, gen, self.device)

    # -- compute --------------------------------------------------------
    def prefill(self, params, batch, cache):
        return T.prefill(params, self.cfg, batch, cache)

    def decode_step(self, params, token, cache):
        return T.decode_step(params, self.cfg, token, cache)

    def init_cache(self, batch_size, max_len, *, dtype=torch.bfloat16,
                   window: Optional[int] = None):
        return T.init_cache(self.cfg, batch_size, max_len, dtype=dtype,
                            window=window, device=self.device)

    def reset_cache(self, cache):
        return T.reset_cache(cache)


def build_model(cfg: ArchConfig, device=None) -> Model:
    """device: None -> cuda:0 (raises without CUDA); "cpu" on request."""
    T.check_supported(cfg)
    return Model(cfg, resolve_device(device))
