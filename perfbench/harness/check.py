"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the weights
are drawn again from the seed and the plain reference
(``reference/<family>.py``, float32, TF32 off) runs over each sampled
request's prompt.  Compared, each against the configuration's limit:

- ``unanswered``: requests sent that no pump
  answered within a minute of the close, and answers to no request;
- ``missing``: sampled requests whose pass left no logits in the tap
  (``serve.LogitsTap``): the timed path bypassed ``Model.prefill``;
- ``token_mismatch``: sampled requests whose served token is not the
  argmax of the logits their pass produced;
- ``logit_err``: the widest gap between a served row's logits and the
  reference's, over the row's largest reference logit, over the sample;
- ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best, over the sample.

The control (``control_numbers``) puts the reference computed in TF32 in
the program's place: ``logit_err`` at the prompts' last positions, and
``token_gap`` at every position of the same prompts, of the token TF32
puts first.
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from .cell import BENCH_DIR

REF_BLOCK = 32          # prompts a reference block
ALL_POS_BLOCK = 8       # prompts a block where every position's logits are read


def reference_module(family: str):
    ref_dir = str(BENCH_DIR / "reference")
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    from .cell import family_module
    return family_module("reference", family)


def _blocks(ref, params, sz, prompts: np.ndarray, device, precision, block):
    """(lo, final hidden states) of ``prompts`` (n, S), a block at a time."""
    from ref_common import Precision
    pr = Precision(precision)
    for lo in range(0, len(prompts), block):
        toks = torch.from_numpy(np.ascontiguousarray(prompts[lo:lo + block])).to(device)
        with torch.inference_mode(), pr.active(device):     # never held across a yield
            h = ref.hidden(params, sz, toks, pr)
        yield lo, pr, h


def reference_logits(ref, params, sz, prompts: np.ndarray, device, precision="float32"):
    """(n, V) last-position logits of ``prompts`` (n, S)."""
    out = []
    for _, pr, h in _blocks(ref, params, sz, prompts, device, precision, REF_BLOCK):
        with torch.inference_mode(), pr.active(device):
            out.append(ref.head(params, h[:, -1], pr))
    return torch.cat(out)


def gaps(ref_logits, tokens) -> torch.Tensor:
    """max(ref) - ref[token], row by row (any leading shape)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens[..., None].long())[..., 0]


def logit_errs(served, ref_logits) -> torch.Tensor:
    return (served.float() - ref_logits).abs().amax(-1) / ref_logits.abs().amax(-1)


def compare(served: Dict[int, object], prompts_of, ref, params, sz, device,
            unanswered: int) -> Dict[str, float]:
    """``served``: rid -> (logits row, served token) or None."""
    have = [r for r, v in served.items() if v is not None]
    numbers = {"unanswered": float(unanswered),
               "missing": float(len(served) - len(have))}
    if not have:
        return {**numbers, "token_mismatch": 0.0, "logit_err": float("inf"),
                "token_gap": float("inf")}
    rows = torch.stack([served[r][0].float() for r in have]).to(device)
    toks = torch.tensor([served[r][1] for r in have], device=device)
    numbers["token_mismatch"] = float((rows.argmax(-1) != toks).sum())
    ref_l = reference_logits(ref, params, sz, np.stack([prompts_of(r) for r in have]), device)
    numbers["logit_err"] = float(logit_errs(rows, ref_l).max())
    numbers["token_gap"] = float(gaps(ref_l, toks).max())
    return numbers


def control_numbers(ref, params, sz, prompts: np.ndarray, device) -> Dict[str, float]:
    """The reference in TF32 in the program's place, on ``prompts``."""
    err = gap = 0.0
    f32_blocks = _blocks(ref, params, sz, prompts, device, "float32", ALL_POS_BLOCK)
    tf32_blocks = _blocks(ref, params, sz, prompts, device, "tf32", ALL_POS_BLOCK)
    for (_, pr32, h32), (_, pr_tf, h_tf) in zip(f32_blocks, tf32_blocks):
        with torch.inference_mode():
            with pr32.active(device):
                f32 = ref.head(params, h32, pr32)
            with pr_tf.active(device):
                tf32 = ref.head(params, h_tf, pr_tf)
            err = max(err, float(logit_errs(tf32[:, -1], f32[:, -1]).max()))
            gap = max(gap, float(gaps(f32, tf32.argmax(-1)).max()))
    return {"logit_err": err, "token_gap": gap}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number without a limit is an error."""
    missing = [k for k in numbers if k not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
