"""Public entry points of the kernels, and their launch counters.

Each wrapper sends a CUDA tensor to its hand-written kernel and a CPU
tensor to its plain PyTorch version (``ref``); it never falls back from
one to the other.  The JAX package's ``INTERPRET`` switch becomes the
tensor's device.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

KERNELS = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["flash_attention", "decode_attention", "reset_launch_counts",
           "launch_counts"]
