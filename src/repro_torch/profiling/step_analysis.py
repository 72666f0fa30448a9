"""Roofline-grade analysis of one step, counted on the ops a rank runs.

Counterpart of the JAX package's ``profiling/hlo_analysis.py``.  There is
no compiled HLO to parse: ``StepAnalysis`` is a ``TorchDispatchMode`` that
sees every ATen op and custom op of one eager step.  An op on DTensors is
handed on to DTensor's own dispatch (the mode returns ``NotImplemented``
for it), so the mode counts the local ops DTensor runs on this rank's
shards and the collectives it issues, the per-device program, and not the
global op.  DTensor's shape propagation, which runs ops on fake global
tensors, is left out.  It counts, per device:

  * flops            -- each op's ``torch.utils.flop_counter`` formula:
                        the products (mm, bmm, addmm, ...) and the model
                        kernels' custom ops, whose formulas
                        ``kernels.ops.register_mesh_rules`` registers
  * hbm_bytes        -- inputs plus output of each op (in eager mode every
                        op is a top-level op; a kernel's interior is not
                        counted, as a fusion's is not in the reference);
                        views, allocations and waits move nothing
  * collective_bytes -- the ``_c10d_functional`` ops with the reference's
                        ring terms and each call's group size g:
                        all-gather (g-1)/g * out; all-reduce 2(g-1)/g * in;
                        reduce-scatter and all-to-all (g-1)/g * in
  * per_collective   -- the same bytes by collective
  * peak_bytes       -- the most bytes of tensors created in the step that
                        were alive at once (storages, so views count once;
                        the step's arguments are not counted)
  * records          -- with ``record=True``, one dict per counted op: the
                        op, its inputs' and outputs' shapes and dtypes, its
                        flops and bytes, and for a collective its kind,
                        group size and ring bytes (the dry run's ``.ops``
                        file, the program the counts were taken from)

An in-place write of a few slots (``index_copy_``) moves twice what it
writes, and ``index_select`` twice what it reads, as the reference counts
a dynamic-update-slice and a dynamic-slice: the buffer they index is not
read whole (a decode step's cache write).

``StepAnalysis(device="meta")`` counts only ops on that device's tensors:
the dry run's shards are meta tensors, and the plain CPU tensors DTensor
makes for its own bookkeeping (shard offsets) are not a rank's work.

``roofline`` turns the counts into seconds with the H100 SXM's constants.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM, NVIDIA's data sheet (dense rates): bf16 on the tensor cores,
# HBM3, and NVLink 4 at 900 GB/s a GPU over both directions, 450 GB/s each
# way (the NVLink Switch System joins up to 256 such GPUs, the 16x16 mesh)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9          # memory of one card

_COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
               "wait_tensor", "device", "dim", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "_local_scalar_dense"}
# ops that touch only the slots they index: twice the slots' bytes
_INDEXED_WRITE = {"index_copy_"}
_INDEXED_READ = {"index_select"}
# DTensor's sharding propagation runs ops on fake global tensors to learn
# the output's shape; they are not the rank's work
_PROPAGATION = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _describe(t) -> str:
    """A tensor's dtype and shape, as ``bf16[8,1,32,128]``."""
    dt = str(t.dtype).replace("torch.", "").replace("bfloat16", "bf16").replace("float", "f")
    return f"{dt}[{','.join(map(str, t.shape))}]"


def _group_size(func, args) -> int:
    """The process group size of a functional collective call."""
    import torch.distributed.distributed_c10d as c10d
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    if name is not None:
        try:
            return c10d._resolve_process_group(name).size()
        except Exception:  # noqa: BLE001 - an older torch resolves no name
            pass
    return next((a for a in args if isinstance(a, int) and not isinstance(a, bool)), 1)


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class StepAnalysis(TorchDispatchMode):
    """Counts flops, bytes, collectives and peak live bytes of the ops run
    under it (``with StepAnalysis() as a: step(...)``)."""

    def __init__(self, device=None, record: bool = False):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor, self._flops = DTensor, flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = 0.0
        self.per_collective: Dict[str, float] = defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self.records = [] if record else None
        self._storages = weakref.WeakKeyDictionary()

    def _free(self, n):
        self.live_bytes -= n

    def _track(self, tensors, new: bool):
        for t in tensors:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            if st in self._storages:
                continue
            n = st.nbytes() if new else 0
            self._storages[st] = n
            if n:
                self.live_bytes += n
                weakref.finalize(st, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # DTensor runs the rank's ops, which come back here
        if self.device is not None and not any(
                isinstance(a, torch.Tensor) and a.device.type == self.device
                for a in tree_flatten(args)[0]):
            return func(*args, **kwargs)
        if _in_propagation():
            return func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        self._track(flat_in, new=False)
        out = func(*args, **kwargs)
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self._track(flat_out, new=True)
        self.ops += 1
        packet = func._overloadpacket
        flops = 0
        if packet in self._flops:
            flops = self._flops[packet](*args, **kwargs, out_val=out)
            self.flops += flops
        rec = None
        if self.records is not None:
            rec = {"op": str(func), "in": [_describe(t) for t in flat_in],
                   "out": [_describe(t) for t in flat_out], "flops": flops, "bytes": 0}
            self.records.append(rec)
        name = packet.__name__
        if getattr(func, "is_view", False) or name in _NO_TRAFFIC:
            return out
        in_b = sum(_nbytes(t) for t in flat_in)
        out_b = sum(_nbytes(t) for t in flat_out)
        if name in _INDEXED_WRITE:
            moved = 2 * (in_b - _nbytes(flat_in[0]))     # all but the buffer written
        elif name in _INDEXED_READ:
            moved = 2 * out_b
        else:
            moved = in_b + out_b
        self.hbm_bytes += moved
        if rec is not None:
            rec["bytes"] = moved
        kind = next((c for c in _COLLECTIVES if c in name), None)
        if kind is not None and "_c10d_functional" in func.namespace:
            g = _group_size(func, args)
            ring = (g - 1) / g if g > 1 else 0.0
            eff = {"all_gather": ring * out_b, "all_reduce": 2.0 * ring * in_b}.get(
                kind, ring * in_b)
            self.collective_bytes += eff
            self.per_collective[kind.replace("_", "-")] += eff
            if rec is not None:
                rec.update(collective=kind.replace("_", "-"), group=g, ring_bytes=eff)
        return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    per_collective: Dict[str, float]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(a: StepAnalysis, *, peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
             link_bw: float = LINK_BW) -> Roofline:
    """Per-device seconds of an analysed step on H100 constants."""
    return Roofline(compute_s=a.flops / peak_flops, memory_s=a.hbm_bytes / hbm_bw,
                    collective_s=a.collective_bytes / link_bw, flops=a.flops,
                    hbm_bytes=a.hbm_bytes, collective_bytes=a.collective_bytes,
                    per_collective=dict(a.per_collective))
