"""Sharded step builders and the abstract inputs of every (arch x shape).

Counterpart of the JAX package's ``launch/steps.py``.  Where JAX jits a
step with in/out shardings, a built step here is a plain callable over
DTensors on a ``DeviceMesh``: its arguments' placements come from the
logical specs resolved on the mesh (``BuiltStep.in_specs``), and the
model's ``ShardingHints`` lay out activations as the reference's
``with_sharding_constraint`` sites do.  DTensor runs each op on the local
shards and issues the collectives; plain tensors the model makes (iotas,
masks) count as replicated.  The same builders drive the real 1x1 mesh on
the card and, on fake tensors, the abstract production mesh of the dry
run.

``input_specs`` and ``abstract_cache`` give meta tensors, which allocate
nothing.  The table values (``SERVE_TP_FIT_BYTES``, ``TRAIN_MICROBATCHES``,
``TRAIN_ACC_DTYPE``, ``TRAIN_OPTIMIZER``) are the reference's, sized there
for a 16 GB device: they are distribution decisions, kept so that the two
packages distribute alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.shapes import SHAPES, InputShape, effective_config
from repro_torch.models import transformer as T
from repro_torch.models.zoo import Model
from repro_torch.training.optimizer import AdamW, AdamWState, QuantState
from repro_torch.training.loop import compute_dtype
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Input specs (meta tensors: never allocated)
# ---------------------------------------------------------------------------

def _model(cfg: ArchConfig) -> Model:
    """A Model whose device is never used: the builders pass their own."""
    T.check_supported(cfg)
    return Model(cfg, META)


def train_input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16) -> Dict[str, Any]:
    specs = _model(cfg).train_batch_specs(shape.global_batch, shape.seq_len, dtype)
    return {k: torch.empty(s, dtype=dt, device=META) for k, (s, dt) in specs.items()}


def abstract_cache(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16):
    """The decode cache on the meta device: one entry per layer, and host
    ints for ``step`` / ``mrope_delta``."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=dtype,
                        window=cfg.sliding_window, device=META)


def decode_input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16):
    return {"token": torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META),
            "cache": abstract_cache(cfg, shape, dtype)}


def prefill_input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16):
    batch = train_input_specs(cfg, shape, dtype)
    del batch["labels"]
    return {"batch": batch, "cache": abstract_cache(cfg, shape, dtype)}


def input_specs(arch: str, shape_name: str, dtype=torch.bfloat16):
    """All model inputs for one (arch, shape) as meta tensors."""
    cfg = effective_config(arch, shape_name)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape, dtype)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, dtype)
    return decode_input_specs(cfg, shape, dtype)


# ---------------------------------------------------------------------------
# Arguments on the mesh
# ---------------------------------------------------------------------------

def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclasses.dataclass
class BuiltStep:
    """A step over DTensors on ``mesh``.

    ``fn`` is a plain callable; ``abstract_args`` its arguments as meta
    tensors (host ints kept); ``in_specs`` the resolved spec of every
    argument leaf, in the arguments' structure, whose ``placements`` are
    its DTensor layout."""
    fn: Callable
    abstract_args: tuple
    in_specs: tuple
    cfg: ArchConfig
    mesh: Any

    def shard(self, *args):
        """Real arguments, whole on every rank, as DTensors with their
        placements (host ints and plain non-tensors pass as they are)."""
        return tuple(self.place(i, a) for i, a in enumerate(args))

    def place(self, index: int, value):
        """One real argument, by its position, as ``shard`` places it."""
        from torch.distributed.tensor import distribute_tensor

        def put(t, spec):
            if not _is_tensor(t):
                return t
            return distribute_tensor(t, self.mesh, sh.placements(spec, self.mesh))
        return tree_map(put, value, self.in_specs[index])

    def abstract_dtensors(self):
        """The arguments as DTensors over rank 0's shards on the meta
        device: ops on them compute shapes only, and nothing is allocated."""
        from torch.distributed.tensor import DTensor

        def make(a, spec):
            if not _is_tensor(a):
                return a
            pl = sh.placements(spec, self.mesh)
            local = torch.empty(sh.local_shape(a.shape, spec, self.mesh), dtype=a.dtype,
                                device=META)
            return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                      shape=tuple(a.shape), stride=_contiguous_stride(a.shape))
        return tuple(tree_map(make, a, s) for a, s in zip(self.abstract_args, self.in_specs))

    def arg_bytes_per_dev(self) -> int:
        """The bytes of rank 0's shards of every argument."""
        total = 0

        def add(a, spec):
            nonlocal total
            if _is_tensor(a):
                total += math.prod(sh.local_shape(a.shape, spec, self.mesh)) * a.element_size()
            return a
        for a, s in zip(self.abstract_args, self.in_specs):
            tree_map(add, a, s)
        return total


def _replicate_plain():
    """Inside a step: plain tensors the model makes (iotas, masks) count as
    replicated DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


SERVE_TP_FIT_BYTES = 6e9   # replicate-over-data threshold for serving params


def _param_specs(model: Model, mesh, dtype, *, serve: bool = False):
    """(abstract params, resolved specs): fsdp dropped for a served model
    whose model-axis shard fits ``SERVE_TP_FIT_BYTES``."""
    abstract = model.abstract_params(dtype)
    drop = frozenset()
    ms = sh.mesh_shape(mesh)
    if serve and "model" in ms:
        total = sum(a.numel() * a.element_size() for a in tree_leaves(abstract))
        if total / ms["model"] <= SERVE_TP_FIT_BYTES:
            # classic TP serving: replicate over data, shard over model
            drop = frozenset({"fsdp"})
    return abstract, sh.resolve_tree(model.param_specs(), abstract, mesh, drop)


def _batch_specs(batch_abs, mesh):
    """The batch dimension over the batch axes, resolved per leaf."""
    return {k: sh.resolve_spec(P(sh.batch_spec(mesh)), tuple(a.shape), mesh)
            for k, a in batch_abs.items()}


# gradient-accumulation factor per arch for train_4k (the reference's table)
TRAIN_MICROBATCHES = {
    "zamba2-2.7b": 4,
    "mixtral-8x22b": 16,
    "dbrx-132b": 16,
}

# gradient-accumulation dtype: bf16 accumulation against the bf16 compute
# copy for the 132-140B MoE models (the reference's table)
TRAIN_ACC_DTYPE = {
    "mixtral-8x22b": torch.bfloat16,
    "dbrx-132b": torch.bfloat16,
}

# 8-bit Adam moments for the 100B+ MoE models (the reference's table)
TRAIN_OPTIMIZER = {
    "mixtral-8x22b": AdamW(quant_min_size=1 << 22),
    "dbrx-132b": AdamW(quant_min_size=1 << 22),
}


def _opt_specs(p_specs, abstract_opt):
    """The moments take their param's spec (a QuantState's q and scale
    both: each rank quantizes its own shard)."""
    def moment(spec, leaf):
        return QuantState(q=spec, scale=spec) if isinstance(leaf, QuantState) else spec
    return AdamWState(step=P(), mu=tree_map(moment, p_specs, abstract_opt.mu),
                      nu=tree_map(moment, p_specs, abstract_opt.nu))


def _value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` with respect to
    every leaf (zeros where the batch does not reach it)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def _microbatches(batch, M: int):
    """The reference's M microbatches (``a.reshape((M, B // M) + ...)``):
    microbatch m holds the global rows m·B/M .. (m+1)·B/M, sharded over the
    batch axes as the batch was (replicated where they do not divide B/M).
    A DTensor batch moves once a step, not once a microbatch: its rows are
    gathered (the int32 tokens and labels), viewed as (M, B/M, ...), and
    each rank keeps its share of the B/M dim."""
    def split(t):
        n = t.shape[0] // M
        if not sh.is_dtensor(t):
            return t.reshape((M, n) + tuple(t.shape[1:]))
        from torch.distributed.tensor import Replicate, Shard
        mesh, pl = t.device_mesh, list(t.placements)
        rows = [i for i, p in enumerate(pl) if p.is_shard(0)]
        even = n % math.prod(mesh.size(i) for i in rows) == 0
        whole = [Replicate() if i in rows else p for i, p in enumerate(pl)]
        part = [Shard(1) if i in rows and even else p for i, p in enumerate(whole)]
        v = t.redistribute(mesh, whole).reshape((M, n) + tuple(t.shape[1:]))
        return v.redistribute(mesh, part)
    parts = {k: split(t) for k, t in batch.items()}
    return [{k: v[m] for k, v in parts.items()} for m in range(M)]


def make_train_step(arch: str, mesh, *, shape: Optional[InputShape] = None,
                    policy: Optional[sh.ActivationPolicy] = None,
                    opt: Optional[AdamW] = None, remat: bool = True,
                    microbatches: Optional[int] = None, moe_ep: Optional[bool] = None,
                    cfg: Optional[ArchConfig] = None) -> BuiltStep:
    """fn(params, opt_state, batch) -> (params, opt_state, loss): the loss of
    the params cast to the compute dtype, accumulated over M microbatches
    (``TRAIN_MICROBATCHES``) in ``TRAIN_ACC_DTYPE`` (bf16: differentiated
    with respect to the bf16 compute copy), then one AdamW update.
    ``cfg`` overrides the shape's config (a cut depth)."""
    shape = shape or SHAPES["train_4k"]
    cfg = cfg or effective_config(arch, shape.name)
    policy = policy or sh.ActivationPolicy()
    opt = opt or TRAIN_OPTIMIZER.get(arch, AdamW())
    model = _model(cfg)
    M = microbatches if microbatches is not None else TRAIN_MICROBATCHES.get(arch, 1)
    if shape.global_batch % M:
        raise ValueError(f"make_train_step: batch {shape.global_batch} in {M} microbatches")
    ms = sh.mesh_shape(mesh)

    abstract_params, p_specs = _param_specs(model, mesh, torch.float32)
    hints = dataclasses.replace(policy.hints(mesh, batch=shape.global_batch), mesh=mesh)
    if moe_ep is None:
        # expert parallelism whenever the mesh admits it: n_experts == the
        # data axis and the microbatch shards over all batch axes
        dp_size = math.prod(ms[a] for a in sh.batch_axes(mesh))
        moe_ep = (cfg.is_moe and cfg.n_experts * cfg.expert_shards == ms.get("data", 0)
                  and (shape.global_batch // M) % dp_size == 0)
    if moe_ep:
        if not (cfg.is_moe and cfg.n_experts * cfg.expert_shards == ms.get("data")):
            raise ValueError("EP requires n_experts * expert_shards == data axis size")
        # expert weights: E over data (resident experts), F over model
        hints = dataclasses.replace(hints, moe_ep=("data", sh.batch_axes(mesh)))
        tp = "model" if "model" in ms else None
        for bs in p_specs["blocks"]:
            bs["moe"].update(w_gate=P("data", None, tp), w_up=P("data", None, tp),
                             w_down=P("data", tp, None))
    abstract_opt = opt.init(abstract_params)
    o_specs = _opt_specs(p_specs, abstract_opt)
    batch_abs = train_input_specs(cfg, shape)
    b_specs = _batch_specs(batch_abs, mesh)
    cdt = compute_dtype(cfg)
    acc_dtype = TRAIN_ACC_DTYPE.get(arch, torch.float32)

    def loss_fn(params, batch):
        return model.loss(T.cast_params(params, cdt), batch, remat=remat, shard=hints)

    def train_step(params, opt_state, batch):
        with _replicate_plain():
            if M == 1:
                loss, grads = _value_and_grad(loss_fn, params, batch)
            else:
                if acc_dtype == torch.bfloat16:
                    # differentiate the bf16 compute copy: gradients and the
                    # accumulator are bf16 (vectors stay float32)
                    pc = T.cast_params(params, cdt)
                    mb_loss = lambda p, b: model.loss(p, b, remat=remat, shard=hints)
                    grads = [torch.zeros_like(t) for t in tree_leaves(pc)]
                    target = pc
                else:
                    mb_loss, target = loss_fn, params
                    grads = [torch.zeros_like(t, dtype=acc_dtype) for t in tree_leaves(params)]
                loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
                for mb in _microbatches(batch, M):
                    lm, gm = _value_and_grad(mb_loss, target, mb)
                    grads = [a + g.to(a.dtype) for a, g in zip(grads, gm)]
                    loss = loss + lm
                loss = loss / M
                grads = [g / M for g in grads]
            with torch.no_grad():
                new_params, new_opt = opt.update(tree_unflatten(params, grads), opt_state,
                                                 params)
        return new_params, new_opt, loss

    return BuiltStep(fn=train_step, abstract_args=(abstract_params, abstract_opt, batch_abs),
                     in_specs=(p_specs, o_specs, b_specs), cfg=cfg, mesh=mesh)


def _greedy(logits):
    """The next token, (B, 1) int32; a vocabulary-sharded DTensor's logits
    are gathered first (DTensor's argmax over a sharded dim fails)."""
    return torch.argmax(sh.unshard_dim(logits, -1), dim=-1).to(torch.int32)[:, None]


def make_decode_step(arch: str, mesh, *, shape: Optional[InputShape] = None,
                     policy: Optional[sh.ActivationPolicy] = None,
                     cfg: Optional[ArchConfig] = None) -> BuiltStep:
    """fn(params, token, cache) -> (next greedy token (B, 1) int32, cache):
    bf16 params, the cache updated in place."""
    shape = shape or SHAPES["decode_32k"]
    cfg = cfg or effective_config(arch, shape.name)
    policy = policy or sh.ActivationPolicy(seq_shard_residual=False, kv_seq_shard=True)
    model = _model(cfg)
    abstract_params, p_specs = _param_specs(model, mesh, torch.bfloat16, serve=True)
    cache_abs = abstract_cache(cfg, shape)
    c_specs = sh.cache_specs(cache_abs, mesh, batch=shape.global_batch, policy=policy)
    tok_abs = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META)
    tok_spec = sh.resolve_spec(P(sh.batch_spec(mesh)), tuple(tok_abs.shape), mesh)
    hints = dataclasses.replace(policy.hints(mesh, batch=shape.global_batch, decode=True),
                                mesh=mesh)

    def serve_step(params, token, cache):
        with _replicate_plain():
            logits, cache = model.decode_step(params, token, cache, shard=hints)
            return _greedy(logits[:, -1, :]), cache

    return BuiltStep(fn=serve_step, abstract_args=(abstract_params, tok_abs, cache_abs),
                     in_specs=(p_specs, tok_spec, c_specs), cfg=cfg, mesh=mesh)


def make_prefill_step(arch: str, mesh, *, shape: Optional[InputShape] = None,
                      policy: Optional[sh.ActivationPolicy] = None,
                      cfg: Optional[ArchConfig] = None) -> BuiltStep:
    """fn(params, batch, cache) -> (last token's logits (B, V) float32,
    cache): bf16 params, the cache filled in place."""
    shape = shape or SHAPES["prefill_32k"]
    cfg = cfg or effective_config(arch, shape.name)
    policy = policy or sh.ActivationPolicy(kv_seq_shard=True)
    model = _model(cfg)
    abstract_params, p_specs = _param_specs(model, mesh, torch.bfloat16, serve=True)
    batch_abs = train_input_specs(cfg, shape)
    del batch_abs["labels"]
    cache_abs = abstract_cache(cfg, shape)
    c_specs = sh.cache_specs(cache_abs, mesh, batch=shape.global_batch, policy=policy)
    hints = dataclasses.replace(policy.hints(mesh, batch=shape.global_batch), mesh=mesh)

    def prefill_step(params, batch, cache):
        with _replicate_plain():
            return model.prefill(params, batch, cache, shard=hints)

    return BuiltStep(fn=prefill_step, abstract_args=(abstract_params, batch_abs, cache_abs),
                     in_specs=(p_specs, _batch_specs(batch_abs, mesh), c_specs), cfg=cfg,
                     mesh=mesh)


def build_step(arch: str, shape_name: str, mesh, policy: Optional[sh.ActivationPolicy] = None,
               **kw) -> BuiltStep:
    shape = kw.pop("shape", None) or SHAPES[shape_name]
    if shape.kind == "train":
        return make_train_step(arch, mesh, shape=shape, policy=policy, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(arch, mesh, shape=shape, policy=policy, **kw)
    return make_decode_step(arch, mesh, shape=shape, policy=policy, **kw)
