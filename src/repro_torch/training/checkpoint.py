"""Checkpoints: a tree's leaves in one ``torch.save`` file, with metadata,
behind an atomic rename.

The JAX package's ``training/checkpoint.py`` contract without msgpack:
``save(step)`` writes ``step_{step:08d}.tmp`` and renames it into place,
keeping the newest ``keep``; ``latest_step`` ignores unfinished ``.tmp``
directories; ``restore`` rebuilds the structure of a template tree (an
``AdamWState`` and its ``QuantState`` leaves among it) on the template's
devices.  Leaves are saved from the CPU in their own dtypes (bfloat16
stays bfloat16) and read back with ``weights_only=True``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

LEAVES = "leaves.pt"


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    leaves = [t.detach().cpu() for t in tree_leaves(tree)]
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    torch.save(leaves, os.path.join(tmp, LEAVES))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves),
                   "leaves": [[str(t.dtype), list(t.shape)] for t in leaves]}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    for old in _steps(ckpt_dir)[:-keep]:          # retention
        shutil.rmtree(_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``, each leaf on its template
    leaf's device."""
    leaves = torch.load(os.path.join(_path(ckpt_dir, step), LEAVES), weights_only=True)
    like_leaves = tree_leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"checkpoint step {step}: {len(leaves)} leaves, the template "
                         f"{len(like_leaves)}")
    return tree_unflatten(like, [t.to(l.device) for t, l in zip(leaves, like_leaves)]), step


def restore_latest(ckpt_dir: str, like: Any) -> Optional[Tuple[Any, int]]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, like)
