"""Logical-axis -> mesh-axis resolution and activation sharding policies.

Counterpart of the JAX package's ``distributed/sharding.py``, with the same
rules.  Model code annotates params with *logical* axes ("fsdp", "tp",
"exp"), one entry per tensor dimension (``P("fsdp", "tp")``); this module
resolves them against a mesh:

  fsdp -> "data"   (ZeRO-style parameter/optimizer sharding)
  tp   -> "model"  (tensor parallelism)
  exp  -> "pod"    (expert parallelism across pods, when divisible)

Any axis that does not divide the corresponding dim is dropped
(replicated) rather than erroring.  Resolution reads only the axis sizes:
``mesh`` is a ``DeviceMesh``, a mapping {axis name: size}, or any object
whose ``.shape`` is such a mapping.

A resolved spec becomes DTensor placements with ``placements`` (the
counterpart of the reference's ``shardings_for``): one per mesh dimension, ``Shard(d)`` where the spec names that mesh axis on
tensor dim d (a tuple such as ("pod", "data") shards dim d over both, in
mesh-major order, as JAX does), else ``Replicate()``.

The port's parameter tree has one dict per layer where the JAX package
stacks a leading layer axis, and its decode cache one entry per layer:
``cache_specs`` applies the reference's rule to ``(L,) + shape`` and drops
the first entry, so a per-layer spec is the stacked spec without its
leading ``None``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Mapping, Tuple

import torch

from repro_torch.tree import tree_map

LOGICAL_TO_MESH = {
    "fsdp": "data",
    "tp": "model",
    "exp": "pod",
}


class P:
    """A partition spec: one entry per tensor dimension, each None, an axis
    name or a tuple of axis names (a tuple of one is its name, as JAX's
    ``PartitionSpec`` has it).  Not a tuple, so the port's tree functions
    take it as a leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size} of a DeviceMesh, a mapping, or an object whose
    ``.shape`` is a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, Mapping):
        return mesh
    return mesh.shape


def _mesh_axis_size(shape: Mapping[str, int], name) -> int:
    if isinstance(name, tuple):
        return math.prod(_mesh_axis_size(shape, n) for n in name)
    return shape[name] if name in shape else 0


def resolve_spec(spec: P, shape: Tuple[int, ...], mesh,
                 drop: frozenset = frozenset()) -> P:
    """Translate one logical spec for a tensor of ``shape``."""
    ms = mesh_shape(mesh)
    out, used = [], set()
    for dim, name in enumerate(spec):
        if name is None:
            out.append(None)
            continue
        resolved = []
        for n in (name if isinstance(name, tuple) else (name,)):
            if n in drop:
                continue
            m = LOGICAL_TO_MESH.get(n, n)
            if m in used or m not in ms:
                continue
            resolved.append(m)
        size = math.prod(ms[m] for m in resolved) if resolved else 1
        if resolved and dim < len(shape) and shape[dim] % size == 0 and size > 1:
            out.append(tuple(resolved) if len(resolved) > 1 else resolved[0])
            used.update(resolved)
        else:
            out.append(None)
    return P(*out)


def is_dtensor(x) -> bool:
    """Whether x is a DTensor, without importing DTensor where nothing has."""
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_apply(fn, x, *rest):
    """fn on the local shards of DTensors (plain tensors as they are); each
    tensor fn returns becomes a DTensor with x's mesh and placements.  For
    per-element or per-block work whose blocks never straddle a shard, such
    as the int8 moments' quantization."""
    if not is_dtensor(x):
        return fn(x, *rest)
    from torch.distributed.tensor import DTensor
    out = fn(x.to_local(), *(r.to_local() if is_dtensor(r) else r for r in rest))
    wrap = lambda t: DTensor.from_local(t, x.device_mesh, x.placements, run_check=False)
    return type(out)(*map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def resolve_tree(spec_tree, abstract_tree, mesh, drop: frozenset = frozenset()):
    """Resolve a tree of logical specs against the matching tensors (or
    anything with a ``.shape``); a spec shorter than its tensor is padded
    with None."""
    def f(spec, arr):
        spec = spec if isinstance(spec, P) else P()
        padded = tuple(spec) + (None,) * (len(arr.shape) - len(spec))
        return resolve_spec(P(*padded), tuple(arr.shape), mesh, drop)
    return tree_map(f, spec_tree, abstract_tree)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of a spec on a ``DeviceMesh`` (a mesh dim of one
    device replicates: sharding over it changes nothing)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, axis in enumerate(mesh.mesh_dim_names):
        dims = [d for d, name in enumerate(spec)
                if name == axis or (isinstance(name, tuple) and axis in name)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1 else Replicate())
    return tuple(out)


def constrain(x, spec, mesh):
    """The JAX package's ``with_sharding_constraint``: a DTensor on
    ``mesh`` is redistributed to ``spec``'s placements; anything else, or
    no spec, passes as it is."""
    if spec is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = placements(spec, mesh)
    return x if tuple(x.placements) == target else x.redistribute(mesh, target)


def split_dim(t, dim: int, n: int, *shape):
    """``t`` with ``dim`` reshaped to (n,) + shape, for a plain tensor or a DTensor: a
    DTensor's mesh dims that shard ``dim`` without dividing ``n`` (8 kv
    heads on a 16-way axis) gather it first, as GSPMD replicates a dim it
    cannot split."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        dim = dim % t.dim()
        mesh = t.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim and n % mesh.size(i)
              else p for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    dim = dim % t.dim()
    return t.reshape(tuple(t.shape[:dim]) + (n,) + shape + tuple(t.shape[dim + 1:]))


def unshard_dim(t, dim: int):
    """A DTensor with no mesh dim sharding ``dim`` (those gathered); a plain
    tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def gather_fsdp(w):
    """A DTensor weight gathered over every mesh dim but ``model`` (the
    ZeRO / fsdp all-gather before use; its tp shard kept); anything else
    as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    pl = [p if name == "model" else Replicate()
          for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(mesh, pl)


def replicated(t):
    """A DTensor gathered on every mesh dim; anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def gather_inner(t):
    """A DTensor of rank > 2 with its inner leading dims (1 .. n-2)
    gathered, so a product that flattens the leading dims sees at most the
    first one sharded: a sequence-sharded residual is all-gathered before
    a projection, as Megatron's sequence parallelism does (and as DTensor
    requires, which cannot flatten a second sharded dim).  Anything else
    passes as it is."""
    if not is_dtensor(t) or t.dim() < 3:
        return t
    for d in range(1, t.dim() - 1):
        t = unshard_dim(t, d)
    return t


class _GatherInnerGrad(torch.autograd.Function):
    """Identity forward; the backward gathers the gradient's inner leading
    dims (``gather_inner``)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def gather_inner_grad(t):
    """``t``, whose gradient on a DTensor has its inner leading dims
    gathered: a product's output, whose gradient DTensor's autograd may
    hand back sequence-sharded (as a later residual's layout), and whose
    backward flattens the leading dims.  Anything else passes as it is."""
    if not is_dtensor(t) or t.dim() < 3:
        return t
    return _GatherInnerGrad.apply(t)


def merge_dims(t, dim: int):
    """``t.flatten(dim, dim + 1)``; on a DTensor its gradient is split back
    with ``split_dim``, so a gradient sharded where the split cannot follow
    (48 heads over 16 ranks into 8 groups of 6) is gathered first."""
    if not is_dtensor(t):
        return t.flatten(dim, dim + 1)

    class _Merge(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            d = ctx.dim = dim % x.dim()
            ctx.n, ctx.m = x.shape[d], x.shape[d + 1]
            return x.reshape(x.shape[:d] + (ctx.n * ctx.m,) + x.shape[d + 2:])

        @staticmethod
        def backward(ctx, g):
            return split_dim(g, ctx.dim, ctx.n, ctx.m)
    return _Merge.apply(t)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """Rank 0's shard shape under a resolved spec: each sharded dim cut
    into chunks as ``torch.chunk`` cuts it (the first is the largest)."""
    ms = mesh_shape(mesh)
    return tuple(-(-n // max(_mesh_axis_size(ms, name), 1)) if name is not None else n
                 for n, name in zip(tuple(shape), tuple(spec) + (None,) * len(shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    ms = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)


def batch_spec(mesh):
    """The batch dimension's entry: the batch axes, a single name for one."""
    dp = batch_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


@dataclasses.dataclass(frozen=True)
class ActivationPolicy:
    """Per-shape activation sharding knobs."""
    shard_batch: bool = True
    seq_shard_residual: bool = True     # sequence-parallel residuals over model
    vocab_shard_logits: bool = True
    kv_seq_shard: bool = False          # decode KV cache: shard S over model

    def hints(self, mesh, *, batch: int, decode: bool = False):
        """``transformer.ShardingHints`` with resolved specs (no mesh
        attached: ``steps`` adds it)."""
        from repro_torch.models.transformer import ShardingHints
        ms = mesh_shape(mesh)
        dp = batch_axes(ms)
        bspec = dp if (self.shard_batch and batch % max(
            1, _mesh_axis_size(ms, dp)) == 0) else None
        seq = "model" if (self.seq_shard_residual and not decode
                          and "model" in ms) else None
        logits = P(bspec, None,
                   "model" if self.vocab_shard_logits and "model" in ms else None)
        tp = "model" if "model" in ms else None
        return ShardingHints(residual=P(bspec, seq, None), logits=logits, kv=None,
                             moe_w_in=P(None, None, tp), moe_w_out=P(None, tp, None))


def _cache_leaf_spec(shape, ms, batch: int, b_ok: bool, policy: ActivationPolicy) -> P:
    """The reference's rule for one stacked cache leaf (L, B, ...)."""
    dp = batch_axes(ms)
    if len(shape) == 0:
        return P()
    spec = [None] * len(shape)
    # the batch dim: stacked caches have a leading L and the batch second;
    # prefer dim 1 (dim 0 is the layer stack and may equal the batch)
    bdim = None
    if len(shape) >= 2 and shape[1] == batch:
        bdim = 1
    else:
        for d, s in enumerate(shape):
            if s == batch:
                bdim = d
                break
    if bdim is not None and b_ok:
        spec[bdim] = dp if len(dp) > 1 else dp[0]
    if "model" in ms:
        m = ms["model"]
        if len(shape) == 5 and bdim == 1:
            # KV cache (L, B, KV, S, hd) heads-major, or SSM state
            # (L, B, H, hd, N): the seq dim is the larger of dims 2/3
            sdim = 2 if shape[2] >= shape[3] else 3
            if policy.kv_seq_shard and shape[sdim] % m == 0 and shape[sdim] >= 2048:
                spec[sdim] = "model"
        if not b_ok and len(shape) >= 3 and bdim == 1:
            # batch 1: shard the longest remaining dim
            s, d = max((s, d) for d, s in enumerate(shape) if d > 1)
            if s % m == 0 and s >= m:
                spec[d] = "model"
    return resolve_spec(P(*spec), shape, ms)


def cache_specs(cache, mesh, *, batch: int, policy: ActivationPolicy) -> Any:
    """Resolved specs for a decode cache, in the cache's own structure (a
    ``KVCache`` of specs for a ``KVCache``).  Rules by rank and shape, on
    the stacked (L,) + shape:

      KV k/v    (L, B, KV, S, hd): batch over dp; S over model if kv_seq_shard
      pos       (L, B)           : batch over dp
      mamba ssm (L, B, H, hd, N) : batch over dp
      rwkv state (L, B, H, hd, hd): batch over dp
      conv / x prev (L, B, *, d) : batch over dp
      cross k/v (L, B, Se, KV, hd): batch over dp
      step, mrope_delta (host ints): P()
    """
    ms = mesh_shape(mesh)
    dp = batch_axes(ms)
    b_ok = batch % max(_mesh_axis_size(ms, dp), 1) == 0 and policy.shard_batch

    def leaf(x, L):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return P()
        stacked = _cache_leaf_spec((L,) + tuple(x.shape), ms, batch, b_ok, policy)
        return P(*tuple(stacked)[1:])
    def entry(v):      # a list of per-layer entries: its length is the layer count
        L = len(v) if isinstance(v, list) else 1
        return tree_map(lambda x: leaf(x, L), v)
    return {k: entry(v) for k, v in cache.items()}
