"""Weights drawn from the run's seed, on the device, in a few large calls.

The tree's shapes come from the program (``Model.abstract_params``); the
values are the benchmark's own: one flat float32 buffer filled with
standard normals by a ``torch.Generator`` on the device (a few calls of at
most 2**30 numbers), each leaf a view into it, 64-element aligned, then
shifted and scaled in place by the configuration's ``init`` rules.  The
same seed gives the same weights, so the reference can draw them again
after the program's state is freed.

A rule is ``{"match": glob, "mean": m, "std": s}`` or ``{"match": glob,
"fan_in_axis": a}`` (std = 1 / sqrt(shape[a])), matched in order against
the leaf's dotted path (``blocks.3.attn.wq``); the first match wins.
Without a match a leaf of two or more dimensions takes fan_in_axis 0 and a
vector is zero.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict, List, Tuple

import torch

ALIGN = 64                 # elements: 256-byte aligned views
CHUNK = 1 << 30            # numbers drawn per call


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(dotted path, leaf) in the tree's fixed order (dict order, then
    list order)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _set(tree, path: str, value):
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None


def rule_for(path: str, shape, rules: List[Dict]) -> Tuple[float, float]:
    """(mean, std) of the leaf at ``path``."""
    for r in rules:
        if fnmatch.fnmatchcase(path, r["match"]):
            if "fan_in_axis" in r:
                return 0.0, 1.0 / math.sqrt(shape[r["fan_in_axis"]])
            return float(r.get("mean", 0.0)), float(r.get("std", 0.0))
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(shape[0])
    return 0.0, 0.0


def make_weights(abstract, rules: List[Dict], seed: int, device) -> Dict:
    """The tree of ``abstract`` (meta tensors) filled from ``seed``."""
    leaves = leaf_paths(abstract)
    offsets, total = [], 0
    for _, leaf in leaves:
        offsets.append(total)
        total += -(-leaf.numel() // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for lo in range(0, total, CHUNK):
        flat[lo:lo + CHUNK].normal_(generator=gen)
    out = _copy_structure(abstract)
    for (path, leaf), off in zip(leaves, offsets):
        if leaf.dtype != torch.float32:
            raise ValueError(f"{path}: the benchmark serves float32 weights, not {leaf.dtype}")
        view = flat[off:off + leaf.numel()].view(leaf.shape)
        mean, std = rule_for(path, tuple(leaf.shape), rules)
        view.mul_(std)
        if mean:
            view.add_(mean)
        _set(out, path, view)
    return out
