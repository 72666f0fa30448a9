"""Training loop: the step (forward, backward, AdamW), the data pipeline,
checkpoints and logging.

Counterpart of the JAX package's ``training/loop.py``.  ``train`` runs on
cuda:0 unless given ``device="cpu"`` and raises without CUDA.  The step
casts the float32 master params to the config's compute dtype, takes the
loss without remat, differentiates it (through the kernels' autograd
wrappers) and updates params and moments; ``make_step`` builds it, so a
test can drive it from carried-over params.

Unlike the JAX loop, a run restored from a checkpoint at step n skips the
pipeline's first n batches, so it continues on the batches an
uninterrupted run would have seen (the JAX loop starts the stream again).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.zoo import Model, build_model
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import AdamW
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    tokens_per_s: float
    steps: int


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.float32 if cfg.dtype == "float32" else torch.bfloat16


def make_step(model: Model, opt: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the loss
    of the params cast to the compute dtype, its gradient with respect to
    the float32 params (zeros for a leaf the batch does not reach, as JAX
    gives), and one AdamW update.  The loss stays on the device."""
    dtype = compute_dtype(model.cfg)

    def step(params, opt_state, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.profiler.record_function("train.forward_backward"):
            loss = model.loss(T.cast_params(tree_unflatten(params, leaves), dtype),
                              batch, remat=False)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad(), torch.profiler.record_function("train.optimizer"):
            params, opt_state = opt.update(tree_unflatten(params, grads), opt_state,
                                           tree_unflatten(params, [t.detach() for t in leaves]))
        return params, opt_state, loss.detach()

    return step


def to_device(batch, device):
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg: ArchConfig, *, steps: int = 200, batch: int = 8, seq: int = 128,
          seed: int = 0, opt: Optional[AdamW] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          log_every: int = 20, log_fn: Callable[[str], None] = print,
          device=None) -> TrainReport:
    """Single-device training driver; ``device`` None is cuda:0."""
    model = build_model(cfg, resolve_device(device))
    opt = opt or AdamW(lr=1e-3, warmup_steps=20, total_steps=steps,
                       weight_decay=0.01)
    params = model.init(seed)
    opt_state = opt.init(params)
    start_step = 0
    if ckpt_dir:
        restored = ckpt_lib.restore_latest(ckpt_dir, (params, opt_state))
        if restored:
            (params, opt_state), start_step = restored
            log_fn(f"restored checkpoint at step {start_step}")
    step_fn = make_step(model, opt)
    data = make_pipeline(cfg, batch, seq, seed=seed)
    for _ in range(start_step):
        next(data)
    losses: List[float] = []
    t0 = time.time()
    n_tokens = 0
    for i in range(start_step, steps):
        params, opt_state, loss = step_fn(params, opt_state, to_device(next(data), model.device))
        losses.append(float(loss))
        n_tokens += batch * seq
        if (i + 1) % log_every == 0:
            log_fn(f"step {i+1:5d} loss {np.mean(losses[-log_every:]):.4f}")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, i + 1, (params, opt_state))
    dt = time.time() - t0
    return TrainReport(losses=losses, tokens_per_s=n_tokens / max(dt, 1e-9),
                       steps=steps)
