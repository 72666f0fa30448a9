"""The four assigned input shapes and per-(arch x shape) applicability.

A copy of the JAX package's ``launch/shapes.py`` over the port's configs:

  train_4k      seq 4,096   global_batch 256   (training, train_step)
  prefill_32k   seq 32,768  global_batch 32    (inference prefill)
  decode_32k    seq 32,768  global_batch 128   (one decode token, KV=seq)
  long_500k     seq 524,288 global_batch 1     (long-context decode)

long_500k requires sub-quadratic attention: SSM/hybrid/SWA archs run it;
pure full-attention archs are skipped.  qwen3-4b runs it via the
sliding-window variant (qwen3-4b-swa).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: str, shape_name: str) -> bool:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if arch == "qwen3-4b":
            return True          # via the SWA variant
        return cfg.subquadratic
    return True


def effective_config(arch: str, shape_name: str) -> ArchConfig:
    """Arch config actually run for a shape (long-context variants)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if arch == "qwen3-4b":
            cfg = get_config("qwen3-4b-swa")
        if cfg.shared_attn_every and cfg.sliding_window is None:
            # zamba2: the shared attention block runs windowed at 500k
            cfg = cfg.replace(sliding_window=4096)
    return cfg


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if applicable(arch, shape_name):
        return None
    return ("pure full-attention arch: O(S) KV at 524k infeasible without a "
            "sub-quadratic variant (see DESIGN.md)")
