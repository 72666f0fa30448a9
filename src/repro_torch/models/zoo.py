"""Model zoo: a uniform Model facade over the transformer assembly.

Counterpart of the JAX package's ``models/zoo.py``.  A ``Model`` is
bound to a device; ``init(seed)`` draws its weights, and
``make_train_batch`` a random batch, from a ``torch.Generator`` on that
device (not draw for draw with ``jax.random``: parity tests feed both
packages the data pipeline's batches).  ``param_specs`` gives the logical
sharding specs of the parameter tree and ``abstract_params`` its shapes
and dtypes on the meta device (the mesh layer's inputs); the compute
methods take the mesh's ``ShardingHints`` as ``shard``.

``prefill`` replays a CUDA graph of ``transformer.prefill`` where the call
allows it (on a card, autograd off, no hints: ``models/graphs.py``) and
runs it eagerly otherwise; the outputs are the same bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.graphs import PrefillGraphs


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    graphs: PrefillGraphs = dataclasses.field(default_factory=PrefillGraphs, compare=False,
                                              repr=False)

    # -- params ---------------------------------------------------------
    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return T.init_params(self.cfg, gen, self.device)

    def param_specs(self):
        return T.param_specs(self.cfg)

    def abstract_params(self, dtype=torch.bfloat16):
        return T.abstract_params(self.cfg, dtype)

    # -- compute --------------------------------------------------------
    def loss(self, params, batch, *, remat=True, shard=T.NO_HINTS):
        return T.train_loss(params, self.cfg, batch, remat=remat, shard=shard)

    def forward(self, params, batch, *, remat=False, shard=T.NO_HINTS):
        return T.forward(params, self.cfg, batch, remat=remat, shard=shard)

    def prefill(self, params, batch, cache, *, shard=T.NO_HINTS):
        return self.graphs.prefill(self.cfg, self.device, params, batch, cache, shard)

    def decode_step(self, params, token, cache, *, shard=T.NO_HINTS):
        return T.decode_step(params, self.cfg, token, cache, shard=shard)

    def init_cache(self, batch_size, max_len, *, dtype=torch.bfloat16,
                   window: Optional[int] = None):
        return T.init_cache(self.cfg, batch_size, max_len, dtype=dtype,
                            window=window, device=self.device)

    def reset_cache(self, cache):
        return T.reset_cache(cache)

    # -- input builders ---------------------------------------------------
    def train_batch_specs(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{key: (shape, dtype)} of a training batch."""
        cfg = self.cfg
        out = {"tokens": ((batch, seq), torch.int32), "labels": ((batch, seq), torch.int32)}
        if cfg.frontend == "audio":
            out["frames"] = ((batch, cfg.encoder_seq_len, cfg.d_model), dtype)
        if cfg.frontend == "vision":
            fd = cfg.frontend_dim or cfg.d_model
            out["patches"] = ((batch, min(cfg.vision_patches, seq), fd), dtype)
        return out

    def make_train_batch(self, generator: torch.Generator, batch: int, seq: int):
        """Uniform tokens and labels in [0, vocab), standard-normal float32
        frames or patches, drawn from ``generator`` on the model's device."""
        kw = dict(generator=generator, device=self.device)
        out = {}
        for key, (shape, dtype) in self.train_batch_specs(batch, seq).items():
            if dtype == torch.int32:
                out[key] = torch.randint(0, self.cfg.vocab_size, shape, dtype=dtype, **kw)
            else:
                out[key] = torch.randn(shape, dtype=torch.float32, **kw)
        return out


def build_model(cfg: ArchConfig, device=None) -> Model:
    """device: None -> cuda:0 (raises without CUDA); "cpu" on request."""
    T.check_supported(cfg)
    return Model(cfg, resolve_device(device))
