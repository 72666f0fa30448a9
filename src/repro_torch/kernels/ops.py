"""Public entry points of the kernels, and their launch counters.

Each wrapper sends a CUDA tensor to its hand-written kernel and a CPU
tensor to its plain PyTorch version (``ref``); it never falls back from
one to the other.  The JAX package's ``INTERPRET`` switch becomes the
tensor's device.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grant_loop import alloc_all
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.tables import tables

KERNELS = {"flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "rwkv6_scan": rwkv6_scan,
           "ssd_scan": ssd_scan,
           "alloc_all": alloc_all,
           "tables": tables}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["flash_attention", "decode_attention", "rwkv6_scan", "ssd_scan",
           "alloc_all", "tables", "reset_launch_counts", "launch_counts"]
