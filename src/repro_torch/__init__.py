"""PyTorch/CUDA port of the iGniter reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
module names.  It imports ``torch`` and never ``jax`` or ``repro``.

Ported so far: the config registry; the model path of three families
(``models``: dense attention as qwen3-4b, RWKV6 as rwkv6-1.6b, Mamba2 with
shared attention as zamba2-2.7b) and the serving engine
(``serving.engine``), through four kernels hand-written in CUDA C++ for
sm_90a (flash and decode attention in ``kernels/csrc/attention.cu``, the
RWKV6 and SSD scans in ``kernels/csrc/scan.cu``); and the iGniter planner
(``core``: the interference model, the queueing budget, Theorem 1 and
Alg. 1/2 with the plan edits), whose Alg. 2 grant loop runs as the CUDA
kernel in ``kernels/csrc/planner.cu`` behind ``backend="torch"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
