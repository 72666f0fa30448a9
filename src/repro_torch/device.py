"""Device selection for the port's entry points.

The port runs on the GPU.  ``resolve_device()`` with no argument returns
``cuda:0`` and raises when CUDA is absent: there is no silent fallback to
the CPU.  The CPU is used only when the caller asks for it by name, as
the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda:0; "cpu" -> cpu; "cuda[:i]" -> that card.

    Raises RuntimeError when a CUDA device is wanted and CUDA is absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
