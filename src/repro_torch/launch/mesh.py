"""Mesh construction: the 1x1 smoke mesh on the card, and the abstract
production meshes of the dry run.

Functions, not module-level constants, so importing this module never
starts a process group; callers opt in explicitly.  Each mesh maker also
registers the kernels' DTensor sharding rules and flop formulas
(``kernels.ops.register_mesh_rules``).
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import register_mesh_rules

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_smoke_mesh(device=None):
    """1x1 ("data", "model") mesh on cuda:0 (raises without CUDA), or on the
    CPU when asked.  Starts a one-rank process group on localhost if none
    is running: nccl on the card, gloo on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    register_mesh_rules()
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False):
    """The abstract production mesh: 16x16 = 256 devices ("data", "model"),
    or with ``multi_pod`` 2x16x16 = 512 ("pod", "data", "model"), over a
    fake process group whose collectives move nothing.

    For the dry run only: it describes the layout of a cluster this process
    does not have, its DTensors hold meta shards, and nothing run on it
    computes values.  Its devices are CUDA devices where torch has CUDA (the
    card's program: DTensor plans collectives by device type) and CPU
    devices where it does not (DTensor's shape propagation makes fake CUDA
    tensors, which a CPU-only torch refuses for some ops); the two differ
    where DTensor swaps an all-to-all for an all-gather on the CPU.  The
    fake group is started here (as rank 0 of 512 ranks, which holds both
    meshes) if no group runs; a real process group cannot share the
    process."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = ((2, 16, 16), POD_AXES) if multi_pod else ((16, 16), AXES)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    if dist.get_world_size() < n:
        raise RuntimeError(f"make_production_mesh: a process group of {dist.get_world_size()} "
                           f"ranks runs; the mesh needs {n}")
    register_mesh_rules()
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
