"""Mixture-of-Experts layer (Mixtral / DBRX style top-k routing).

Counterpart of the JAX package's ``models/moe.py`` (``apply_moe``; the
expert-parallel ``apply_moe_ep`` is not ported).  It computes the same
function:

* router logits in float32, a softmax, the top k with ties to the lower
  expert index (as ``jax.lax.top_k``: a stable descending sort, since
  ``torch.topk``'s tie order is unspecified), gates renormalised by
  max(sum, 1e-9);
* the sequence in chunks (``chunk = max(chunk, min(S, 4096))``, the chunk
  count cut until it divides S), each with a capacity of
  C = max(K, ceil(Sc·K·cf/E)) slots per virtual expert;
* an assignment's position is its running count over its batch row's
  (s, k) order, times ``expert_shards``: the reference repeats the
  one-hot over the ks virtual shards of an expert before summing the
  counts, so it adds the same count ks times.  Positions at or past C
  are dropped and contribute zero, so with ks > 1 an expert keeps only
  ceil(C / ks) assignments a chunk;
* virtual experts (E·ks, D, F/ks), each receiving every kept assignment
  of its expert (SwiGLU sums exactly over F);
* the Switch aux loss, E · Σ_e f_e · p_e · router_aux_loss.

``apply_moe`` gathers the kept tokens into an (E·ks, B, min(ceil(C/ks),
Sc), D) buffer, which holds just the slots the reference can fill, runs the
three expert products batched over the expert axis (``torch.matmul``),
and sums each token's gate-weighted slot outputs back.  Nothing
accumulates through atomics, so a call is deterministic.  ``moe_plain``
is the reference's one-hot dispatch and combine einsums, line for line:
the yardstick of the tests and of ``chip_smoke.py``, never on the served
path.

``apply_moe`` counts, per ``layer``, the assignments it saw and those it
dropped (``drop_counts``, ``reset_drop_counts``), as the kernels count
their launches; the dropped count stays on the tensor's device until it
is read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init

_drops: dict = {}          # layer -> (dropped assignments (tensor), assignments)


def reset_drop_counts():
    _drops.clear()


def drop_counts() -> dict:
    """{layer: (dropped, assignments)} over the calls since the last reset;
    an assignment is one (token, k) pair."""
    return {layer: (int(d), n) for layer, (d, n) in sorted(_drops.items())}


def init_moe(generator, cfg, device):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    sh = cfg.expert_shards
    Ev, Fv = E * sh, ff // sh       # virtual experts (F-split; sh = 1 = off)
    assert ff % sh == 0
    return {
        "router": _dense_init((d, E), generator, device),
        "w_gate": _dense_init((Ev, d, Fv), generator, device, in_axis=1),
        "w_up": _dense_init((Ev, d, Fv), generator, device, in_axis=1),
        "w_down": _dense_init((Ev, Fv, d), generator, device, in_axis=1),
    }


def _route(router_w, x, top_k: int):
    """x: (..., D) -> (top-k ids, normalised gates, full probs)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)         # (..., E)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :top_k], ids[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return ids, gates, probs


def _aux_loss(ids, probs, cfg):
    """Switch load-balance loss over the whole sequence, in float32."""
    E = cfg.n_experts
    frac = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
    prob = probs.mean(dim=(0, 1))
    return E * (frac * prob).sum() * cfg.router_aux_loss


def _chunking(S: int, cfg, chunk: int):
    """(chunks, tokens a chunk, capacity a virtual expert), as the reference
    picks them."""
    E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    chunk = max(chunk, min(S, 4096))
    n = max(1, S // chunk)
    while S % n:
        n -= 1
    Sc = S // n
    return n, Sc, max(K, int(math.ceil(Sc * K * cf / E)))


def _fillable(C: int, Sc: int, ks: int) -> int:
    """The slots of a virtual expert a chunk can fill: an assignment's
    position is ks x its rank, so ks·r < C, and r < Sc (an expert takes at
    most one assignment a token)."""
    return min(-(-C // ks), Sc)


def _positions(ids, E: int, ks: int):
    """ids (B, Sc, K) -> each assignment's position within its expert,
    (B, Sc·K) in (s, k) order: ks times its running count, as the
    reference's ``_dispatch_combine`` computes it."""
    B = ids.shape[0]
    flat_ids = ids.reshape(B, -1, 1)
    oh = F.one_hot(flat_ids[..., 0], E)                          # (B, Sc·K, E)
    rank = (oh.cumsum(1) - oh).gather(2, flat_ids)[..., 0]
    return rank * ks


def _experts_chunk(xc, idc, gtc, w, E: int, C: int, ks: int):
    """One chunk through the experts: xc (B, Sc, D), idc / gtc (B, Sc, K)
    -> (y (B, Sc, D), dropped assignments)."""
    B, Sc, D = xc.shape
    K = idc.shape[-1]
    Ev, Ck = E * ks, _fillable(C, Sc, ks)
    n_slots = Ev * B * Ck
    dev = xc.device
    pos = _positions(idc, E, ks)                                 # (B, Sc·K)
    keep = pos < C
    # the flat (virtual expert, batch row, rank) slot of every assignment's
    # ks virtual shards: (B, Sc·K, ks)
    virt = idc.reshape(B, Sc * K, 1) * ks + torch.arange(ks, device=dev)
    rows = torch.arange(B, device=dev).view(B, 1, 1)
    slot = (virt * B + rows) * Ck + (pos // ks)[..., None]
    # the token that fills each slot; an empty slot reads a zero row, and a
    # dropped assignment writes to a spare last slot
    tok = torch.arange(B * Sc, device=dev).view(B, Sc, 1, 1).expand(B, Sc, K, ks)
    src = torch.full((n_slots + 1,), B * Sc, dtype=torch.long, device=dev)
    src.scatter_(0, torch.where(keep[..., None], slot, n_slots).reshape(-1),
                 tok.reshape(-1))
    xpad = torch.cat([xc.reshape(B * Sc, D), xc.new_zeros((1, D))])
    xe = xpad[src[:n_slots]].view(Ev, B * Ck, D)
    wg, wu, wd = w
    h = F.silu(xe @ wg) * (xe @ wu)                              # (Ev, B·Ck, F/ks)
    oe = (h @ wd).view(n_slots, D)
    # combine: every shard of a kept assignment weighted by its gate
    out = oe[torch.where(keep[..., None], slot, 0)]              # (B, Sc·K, ks, D)
    wts = (gtc.reshape(B, Sc * K, 1) * keep[..., None]).to(xc.dtype)
    y = (out * wts[..., None]).reshape(B, Sc, K * ks, D).sum(2)
    return y, (~keep).sum()


def apply_moe(p, x, cfg, *, chunk: int = 512, layer: int = 0):
    """x: (B, S, D) -> (y, aux_loss); counts drops under ``layer``."""
    B, S, D = x.shape
    E, K, ks = cfg.n_experts, cfg.top_k, cfg.expert_shards
    n, Sc, C = _chunking(S, cfg, chunk)
    ids, gates, probs = _route(p["router"], x, K)
    aux = _aux_loss(ids, probs, cfg)
    w = tuple(p[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down"))
    ys, dropped = [], 0
    for i in range(n):
        part = slice(i * Sc, (i + 1) * Sc)
        yc, d = _experts_chunk(x[:, part], ids[:, part], gates[:, part], w, E, C, ks)
        ys.append(yc)
        dropped = dropped + d
    seen, total = _drops.get(layer, (0, 0))
    _drops[layer] = (seen + dropped, total + B * S * K)
    return (ys[0] if n == 1 else torch.cat(ys, 1)), aux


# ---------------------------------------------------------------------------
# The plain version: the reference's one-hot dispatch and combine
# ---------------------------------------------------------------------------

def _dispatch_combine(ids, gates, E: int, C: int, ks: int = 1):
    """ids, gates: (B, S, K) -> dispatch and combine (B, S, E·ks, C) f32,
    as the reference builds them (``jax.nn.one_hot`` of a position past C
    is a zero row)."""
    B, S, K = ids.shape
    oh = F.one_hot(ids, E).float()                               # (B,S,K,E)
    if ks > 1:
        oh = oh.repeat_interleave(ks, dim=-1)                    # (B,S,K,E·ks)
        E = E * ks
    flat = oh.reshape(B, S * K, E)
    pos = flat.cumsum(1) - flat
    pos = (pos * flat).sum(-1)                                   # (B,S·K)
    keep = pos < C
    posc = (pos[..., None] == torch.arange(C, device=ids.device)).float() * keep[..., None]
    dc = flat[..., :, None] * posc[..., None, :]                 # (B,S·K,E,C)
    dc = dc.reshape(B, S, K, E, C)
    dispatch = dc.sum(2)
    combine = (dc * gates[..., None, None]).sum(2)
    return dispatch, combine


def moe_plain(p, x, cfg, *, chunk: int = 512):
    """The reference's ``apply_moe`` line for line; (y, aux_loss)."""
    B, S, D = x.shape
    E, K, ks = cfg.n_experts, cfg.top_k, cfg.expert_shards
    dtype = x.dtype
    n, Sc, C = _chunking(S, cfg, chunk)
    ids, gates, probs = _route(p["router"], x, K)
    aux = _aux_loss(ids, probs, cfg)
    wg, wu, wd = (p[k].to(dtype) for k in ("w_gate", "w_up", "w_down"))
    ys = []
    for i in range(n):
        part = slice(i * Sc, (i + 1) * Sc)
        dispatch, combine = _dispatch_combine(ids[:, part], gates[:, part], E, C, ks)
        xe = torch.einsum("bsd,bsec->becd", x[:, part], dispatch.to(dtype))
        h = F.silu(torch.einsum("becd,edf->becf", xe, wg))
        h = h * torch.einsum("becd,edf->becf", xe, wu)
        oe = torch.einsum("becf,efd->becd", h, wd)
        ys.append(torch.einsum("becd,bsec->bsd", oe, combine.to(dtype)))
    return (ys[0] if n == 1 else torch.cat(ys, 1)), aux
