"""AdamW with decoupled weight decay on parameter trees (float32 master
params), with optional blockwise int8 moments.

Counterpart of the JAX package's ``training/optimizer.py``: the same
schedule (linear warm-up, cosine decay to ``min_lr_frac``), global-norm
clipping, bias correction, decay of matrices only, and the same int8
quantization (absmax blocks along the last dim, ``torch.round`` halves to
even as ``jnp.round`` does).  Parameters, gradients and moments are the
port's nested dicts and lists of tensors; every quantity, the step and
the learning rate among them, stays on the parameters' device, so an
update makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import local_apply
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # like params (float32, or int8 QuantState)
    nu: Any               # like params


class QuantState(NamedTuple):
    """Blockwise int8 quantized tensor (bnb-style 8-bit optimizer state):
    blocks along the last dim, so q has the param's exact shape and scale
    the shape (..., last // block)."""
    q: torch.Tensor       # int8, param shape
    scale: torch.Tensor   # float32, (..., last // block)


QUANT_BLOCK = 256
SHARD_ALIGN = 16      # max mesh-axis size a sharded last dim must divide by


def choose_block(shape) -> Optional[int]:
    """Largest power-of-two block <= QUANT_BLOCK such that a 16-way-sharded
    last dim still holds an integer number of blocks per shard (the JAX
    package's rule, kept so both quantize the same leaves alike)."""
    if len(shape) < 2:
        return None
    last = shape[-1]
    per_shard = last // SHARD_ALIGN if last % SHARD_ALIGN == 0 else last
    b = QUANT_BLOCK
    while b >= 16:
        if per_shard % b == 0 and last % b == 0:
            return b
        b //= 2
    return None


def quantizable(shape) -> bool:
    return choose_block(shape) is not None


def _quantize(x: torch.Tensor) -> QuantState:
    """A DTensor leaf is quantized shard by shard with the block its whole
    shape chooses (a block never straddles a shard of a last dim split up
    to 16 ways), q and scale taking its placements."""
    block = choose_block(tuple(x.shape))
    return local_apply(lambda t: _quantize_block(t, block), x)


def _quantize_block(x: torch.Tensor, block: int) -> QuantState:
    lead, last = tuple(x.shape[:-1]), x.shape[-1]
    blocks = x.reshape(lead + (last // block, block))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QuantState(q=q.reshape(x.shape), scale=scale[..., 0])


def _dequantize(qs: QuantState, shape) -> torch.Tensor:
    return local_apply(lambda q, s: _dequantize_local(QuantState(q, s), tuple(q.shape)),
                       qs.q, qs.scale)


def _dequantize_local(qs: QuantState, shape) -> torch.Tensor:
    lead, last = tuple(shape[:-1]), shape[-1]
    n_blocks = qs.scale.shape[-1]
    blocks = qs.q.float().reshape(lead + (n_blocks, last // n_blocks))
    return (blocks * qs.scale[..., None]).reshape(shape)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # 8-bit blockwise-quantized moments for matrices of at least this many
    # elements; None disables quantization
    quant_min_size: Optional[int] = None

    def _quantized(self, a) -> bool:
        return (self.quant_min_size is not None and a.dim() >= 2
                and a.numel() >= self.quant_min_size and quantizable(tuple(a.shape)))

    def init(self, params) -> AdamWState:
        def z(a):      # zeros_like: a DTensor leaf's moments take its placements
            zeros = torch.zeros_like(a, dtype=torch.float32)
            return _quantize(zeros) if self._quantized(a) else zeros
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=tree_map(z, params), nu=tree_map(z, params))

    def schedule(self, step):
        step = step.float()
        warm = torch.clamp((step + 1.0) / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1.0 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def update(self, grads, state: AdamWState, params):
        """One step -> (new params, new state); the inputs are left as
        they were."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip is not None:
            gnorm = torch.sqrt(sum(g.square().sum() for g in tree_leaves(grads)) + 1e-12)
            scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        lr = self.schedule(step)
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()

        def leaf(p, g, m, v):
            is_q = isinstance(m, QuantState)
            mf = _dequantize(m, p.shape) if is_q else m
            vf = _dequantize(v, p.shape) if is_q else v
            mf = self.b1 * mf + (1 - self.b1) * g
            vf = self.b2 * vf + (1 - self.b2) * g * g
            step_ = (mf / b1c) / (torch.sqrt(vf / b2c) + self.eps)
            if p.dim() >= 2:        # decay matrices only
                step_ = step_ + self.weight_decay * p
            return ((p - lr * step_).to(p.dtype),
                    _quantize(mf) if is_q else mf, _quantize(vf) if is_q else vf)

        out = tree_map(leaf, params, grads, state.mu, state.nu)
        pick = lambda i: tree_map(lambda _, t: t[i], params, out)
        return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))
