"""Public entry points of the kernels, and their launch counters.

Each wrapper sends a CUDA tensor to its hand-written kernel and a CPU
tensor to its plain PyTorch version (``ref``); it never falls back from
one to the other.  The JAX package's ``INTERPRET`` switch becomes the
tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (combine_partials, decode_attention,
                                                   decode_attention_partial)
from repro_torch.kernels.flash_attention import flash_attention, mla_widths
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.grant_loop import alloc_all
from repro_torch.kernels.moe_gemm import moe_experts
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.tables import tables

KERNELS = {"flash_attention": flash_attention,
           "flash_attention_mla": mla_widths,      # of flash_attention's, at K 192 / V 128
           "decode_attention": decode_attention,
           "decode_attention_partial": decode_attention_partial,
           "rwkv6_scan": rwkv6_scan,
           "ssd_scan": ssd_scan,
           "moe_experts": moe_experts,
           "gemm": gemm,
           "alloc_all": alloc_all,
           "tables": tables}


_MESH_RULES = []


def register_mesh_rules():
    """Register, once a process, each model kernel's DTensor sharding rule
    (``register_sharding``) and flop formula (``register_flop_formula``) on
    its custom op.  The mesh layer calls it; the served path never imports
    ``torch.distributed.tensor``."""
    if _MESH_RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssd_scan as ss
    for mod, op in ((fa, torch.ops.repro.flash_attention), (da, torch.ops.repro.decode_attention),
                    (rw, torch.ops.repro.rwkv6_scan), (ss, torch.ops.repro.ssd_scan)):
        register_sharding(op.default)(mod.sharding_rule)
        register_flop_formula(op)(mod.flops)
        _MESH_RULES.append(op)
    # the partial variant runs on plain local shards (inside local_map):
    # a flop formula and no sharding rule
    partial = torch.ops.repro.decode_attention_partial
    register_flop_formula(partial)(da.flops)
    _MESH_RULES.append(partial)
    register_sharding(torch.ops.aten.fill_.Tensor)(_fill_rule)


def _fill_rule(self, value):
    """``t.fill_(v)`` (the caches' position counters) on a DTensor, which
    DTensor has no rule for: any layout of t, the 0-d value replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()], [Replicate(), Replicate()])] + [
        ([Shard(d)], [Shard(d), Replicate()]) for d in range(len(self.shape))]


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    gemm.declined = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["flash_attention", "decode_attention", "decode_attention_partial",
           "combine_partials", "rwkv6_scan", "ssd_scan", "moe_experts", "gemm",
           "alloc_all", "tables", "reset_launch_counts", "launch_counts",
           "register_mesh_rules"]
