"""PyTorch/CUDA port of the iGniter reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
module names.  It imports ``torch`` and never ``jax`` or ``repro``.

Ported so far: the config registry, the dense-attention model path
(``models``) and the serving engine (``serving.engine``), with the two
attention kernels hand-written in CUDA C++ for sm_90a
(``kernels/csrc/attention.cu``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
