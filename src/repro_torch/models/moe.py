"""Mixture-of-Experts layer (Mixtral / DBRX style top-k routing), and the
dropless served layer of granite-4.0-h and DeepSeek-V2.

Counterpart of the JAX package's ``models/moe.py``: ``apply_moe``, and
``apply_moe_ep``, the expert-parallel layer for a mesh (below).  The port
adds ``apply_moe_dropless`` (further below), which the JAX package has
not.
``apply_moe`` computes the same function:

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

``apply_moe_ep`` moves tokens instead of weights, on a ``DeviceMesh``
whose expert axis holds one virtual expert per rank: ``local_map`` hands
each rank its shards, which go through the reference's layout with
functional collectives (an all-to-all over the expert axis, an
all-gather and a reduce-scatter over tp, an all-to-all back).

``apply_moe`` counts, per ``layer``, the assignments it saw and those it
dropped (``drop_counts``, ``reset_drop_counts``), as the kernels count
their launches; the dropped count stays on the tensor's device until it
is read (an integer tensor: it holds no graph), and a remat recompute in
the backward counts again.  ``apply_moe_dropless`` counts in
``held_counts`` (below).  A layer's device counts are one tensor, made on
its first call and added to in place ever after (a reset zeroes it), so a
CUDA graph that captured the call adds to it on every replay; the host
counts (``tallies``) are what ``models/graphs.py`` advances on a replay.
Training differentiates ``apply_moe`` as it is: the gather and combine are
indexing, so the gradient reaches the experts, the gates (and through them
the router) and the aux loss.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P, constrain, is_dtensor, mesh_shape, placements
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gemm import TILE_ROWS
from repro_torch.models.layers import _dense_init, apply_mlp, init_mlp, mm, specs_mlp
from repro_torch.profiling.spans import span

@dataclasses.dataclass
class Tally:
    """A layer's counts since the last reset: ``dev`` on the device, added to
    in place, and ``host``, counted on the host."""
    dev: torch.Tensor
    host: int = 0


_drops: dict = {}          # layer -> Tally(dropped assignments, assignments)
_held: dict = {}           # layer -> Tally((held, largest rows, past the grid), calls)


def tallies() -> list:
    """Every layer's Tally, dropping and dropless: the host counts a
    replayed graph advances."""
    return [*_drops.values(), *_held.values()]


def _reset(table: dict):
    """Zero each tally in place (a captured graph keeps adding to its
    tensor); a mesh's DTensor count goes."""
    for layer, t in list(table.items()):
        if is_dtensor(t.dev):
            del table[layer]
        else:
            t.dev.zero_()
            t.host = 0


def _tally(table: dict, layer: int, like) -> Tally:
    """``layer``'s Tally, made on its first call on ``like``'s device: zeros
    shaped as ``like``, made outside inference mode, so that any later call
    may add to them in place."""
    t = table.get(layer)
    if t is None or is_dtensor(t.dev) or t.dev.device != like.device:
        with torch.inference_mode(False):
            t = table[layer] = Tally(torch.zeros_like(like))
    return t


def reset_drop_counts():
    _reset(_drops)


def drop_counts() -> dict:
    """{layer: (dropped, assignments)} over the calls since the last reset;
    an assignment is one (token, k) pair."""
    return {layer: (int(t.dev), t.host) for layer, t in sorted(_drops.items()) if t.host}


def _count_dropped(layer: int, dropped, assignments: int):
    if is_dtensor(dropped):         # a mesh's count, summed out of place
        t = _drops.get(layer)
        _drops[layer] = Tally(dropped if t is None else t.dev + dropped,
                              assignments + (0 if t is None else t.host))
        return
    t = _tally(_drops, layer, dropped)
    t.dev.add_(dropped)
    t.host += assignments


def init_moe(generator, cfg, device):
    """The router over all ``n_experts``; the weights of the ``n_held``
    experts this card holds; a shared expert where ``shared_expert_ff``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    sh = cfg.expert_shards
    Ev, Fv = cfg.n_held * sh, ff // sh     # virtual experts (F-split; sh = 1 = off)
    assert ff % sh == 0
    p = {
        "router": _dense_init((d, E), generator, device),
        "w_gate": _dense_init((Ev, d, Fv), generator, device, in_axis=1),
        "w_up": _dense_init((Ev, d, Fv), generator, device, in_axis=1),
        "w_down": _dense_init((Ev, Fv, d), generator, device, in_axis=1),
    }
    if cfg.shared_expert_ff:
        p["shared"] = init_mlp(generator, d, cfg.shared_expert_ff, device)
    return p


def specs_moe(cfg):
    s = {
        "router": P(None, None),
        "w_gate": P("exp", "fsdp", "tp"),
        "w_up": P("exp", "fsdp", "tp"),
        "w_down": P("exp", "tp", "fsdp"),
    }
    if cfg.shared_expert_ff:
        s["shared"] = specs_mlp()
    return s


def _route(router_w, x, top_k: int, norm: bool = True):
    """x: (..., D) -> (top-k ids, gates, full probs): the gates renormalised
    over the k chosen (``norm``), or else the chosen probabilities
    (DeepSeek-V2)."""
    probs = torch.softmax(mm(x.float(), router_w), dim=-1)      # (..., E)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :top_k], ids[..., :top_k]
    if norm:
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


def _experts_chunk_on_mesh(xc, idc, gtc, w, E: int, C: int, ks: int):
    """``_experts_chunk`` on DTensors: each rank takes its batch rows (an
    assignment's slot is counted within its row, so rows split exactly)
    through its tp slice of the experts' F columns (the weights' hint
    layout), and the partial outputs sum over tp, as the reference's
    layout of ``apply_moe`` computes it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xc.device_mesh
    names = mesh.mesh_dim_names
    # the batch axes split the rows where they divide them evenly
    axes = {"pod", "data"} if xc.shape[0] % math.prod(
        mesh.size(i) for i, n in enumerate(names) if n in ("pod", "data")) == 0 else set()
    on = lambda table: tuple(table.get(n, Replicate()) if mesh.size(i) > 1 else Replicate()
                             for i, n in enumerate(names))
    split = lambda p: {n: p for n in axes}
    rows = on(split(Shard(0)))
    # each rank's gradients are partial: a row's over tp (its F slice), a
    # weight's over the batch axes (its rows)
    rows_grad = on({**split(Shard(0)), "model": Partial()})
    fn = local_map(lambda a, b, c, wg, wu, wd: _experts_chunk(a, b, c, (wg, wu, wd), E, C, ks),
                   out_placements=(on({**split(Shard(0)), "model": Partial()}),
                                   on(split(Partial()))),
                   in_placements=(rows, rows, rows, on({"model": Shard(2)}),
                                  on({"model": Shard(2)}), on({"model": Shard(1)})),
                   in_grad_placements=(rows_grad, rows, rows_grad,
                                       on({**split(Partial()), "model": Shard(2)}),
                                       on({**split(Partial()), "model": Shard(2)}),
                                       on({**split(Partial()), "model": Shard(1)})),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xc, idc, gtc, *w)


def apply_moe(p, x, cfg, *, chunk: int = 512, layer: int = 0,
              w_specs=(None, None), mesh=None):
    """x: (B, S, D) -> (y, aux_loss); counts drops under ``layer``.
    ``w_specs``: the layouts of the cast expert weights on ``mesh``, the
    in (E, D, F) and out (E, F, D) ones (the JAX package's once-per-layer
    gather); without a mesh they do nothing."""
    B, S, D = x.shape
    E, K, ks = cfg.n_experts, cfg.top_k, cfg.expert_shards
    n, Sc, C = _chunking(S, cfg, chunk)
    ids, gates, probs = _route(p["router"], x, K)
    aux = _aux_loss(ids, probs, cfg)
    w_in, w_out = w_specs
    w = (constrain(p["w_gate"].to(x.dtype), w_in, mesh),
         constrain(p["w_up"].to(x.dtype), w_in, mesh),
         constrain(p["w_down"].to(x.dtype), w_out, mesh))
    ys, dropped = [], 0
    run = _experts_chunk_on_mesh if is_dtensor(x) else _experts_chunk
    for i in range(n):
        part = slice(i * Sc, (i + 1) * Sc)
        yc, d = run(x[:, part], ids[:, part], gates[:, part], w, E, C, ks)
        ys.append(yc)
        dropped = dropped + d
    _count_dropped(layer, dropped, B * S * K)
    return (ys[0] if n == 1 else torch.cat(ys, 1)), aux


# ---------------------------------------------------------------------------
# The dropless served layer (granite-4.0-h)
# ---------------------------------------------------------------------------

def reset_held_counts():
    _reset(_held)


def held_counts() -> dict:
    """{layer: {"assignments", "max_rows", "dropped", "tiles", "experts",
    "calls"}} over the ``apply_moe_dropless`` calls since the last reset: the
    assignments to held experts (all computed), the most rows one held
    expert took in a call, the assignments past T rows an expert (0: an
    expert takes at most one assignment a token), the token tiles of the
    grouped expert products, sum over held experts of ceil(rows /
    ``moe_gemm.TILE_ROWS``) (each tile streams its expert's weights once;
    the plain CPU version counts the same), and the held experts that had
    rows.  Reading it synchronises with the device; read it after the
    window, as ``drop_counts``."""
    out = {}
    for layer, t in sorted(_held.items()):
        if t.host:
            n, dropped, tiles, experts, rows = t.dev.tolist()
            out[layer] = {"assignments": n, "max_rows": rows, "dropped": dropped,
                          "tiles": tiles, "experts": experts, "calls": t.host}
    return out


def _count_held(layer: int, offsets, T: int):
    """Accumulate a call's counts on the device, in place (no host
    synchronisation): four sums and a max."""
    rows = offsets[1:] - offsets[:-1]
    c = torch.stack([offsets[-1], (rows - T).clamp(min=0).sum(),
                     ((rows + TILE_ROWS - 1) // TILE_ROWS).sum(), (rows > 0).sum(), rows.max()])
    t = _tally(_held, layer, c)
    t.dev[:4].add_(c[:4])
    torch.maximum(t.dev[4:], c[4:], out=t.dev[4:])
    t.host += 1


def route_sorted(router_w, x, K: int, held: int, norm: bool = True):
    """Route the tokens x (T, D) over all experts and sort the assignments
    by expert, on the device -> (tok, gates, offsets, pos): each sorted
    assignment's token and gate (T·K,); offsets (held + 1,), held expert
    e's rows offsets[e] .. offsets[e + 1] - 1, the assignments to experts
    this card does not hold past offsets[held]; pos (T, K), each (token, k)
    assignment's sorted row.  A stable sort on the expert id keeps each
    expert's rows in token order.  ``norm``: as ``_route``."""
    T = x.shape[0]
    ids, gates, _ = _route(router_w, x, K, norm)                 # (T, K)
    key = torch.where(ids < held, ids, held).reshape(-1)
    key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(key, torch.arange(held + 1, device=x.device, dtype=key.dtype))
    pos = torch.empty_like(perm).scatter_(0, perm, torch.arange(T * K, device=x.device))
    return perm // K, gates.reshape(-1)[perm], offsets, pos.view(T, K)


def apply_moe_dropless(p, x, cfg, *, layer: int = 0):
    """x: (B, S, D) -> (B, S, D): the held experts' part of a dropless
    top-k MoE layer, plus the shared expert.

    The router keeps all ``n_experts`` outputs in float32: softmax, top k
    (ties to the lower expert), gates renormalised over the k chosen, as
    ``_route`` (equal to a softmax over the chosen logits); with
    ``cfg.norm_topk`` false (DeepSeek-V2) the chosen probabilities
    instead.  Each
    assignment to one of the ``n_held`` experts this card holds (experts
    0 .. n_held - 1) is computed, none dropped; the others are this card's
    share of zero (on a card of an expert-parallel group, the other cards
    add theirs).  Everything stays on the device: the assignments sorted by
    expert and each expert's row offsets (``route_sorted``), then the
    grouped expert products and their deterministic combine
    (``ops.moe_experts``), then the shared expert through ``mm``.  Spans
    ``model.moe.route``, ``model.moe.experts`` and ``model.moe.shared``;
    counts under ``layer`` (``held_counts``)."""
    B, S, D = x.shape
    T, K, held = B * S, cfg.top_k, cfg.n_held
    xf = x.reshape(T, D)
    with span("model.moe.route"):
        tok, gates, offsets, pos = route_sorted(p["router"], xf, K, held, cfg.norm_topk)
        _count_held(layer, offsets, T)
    with span("model.moe.experts"):
        y = ops.moe_experts(xf, tok, offsets, gates, pos, p["w_gate"], p["w_up"], p["w_down"])
    y = y.to(x.dtype)
    if "shared" in p:
        with span("model.moe.shared"):
            y = y + apply_mlp(p["shared"], xf)
    return y.view(B, S, D)


def moe_dropless_plain(p, x, cfg):
    """``apply_moe_dropless`` without the sort: each held expert's tokens
    weighted by their gates, plus the shared expert; the yardstick of the
    tests and of ``chip_smoke.py``, never on the served path."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    ids, gates, _ = _route(p["router"], xf, cfg.top_k, cfg.norm_topk)
    y = torch.zeros_like(xf, dtype=torch.float32)
    for e in range(cfg.n_held):
        w = (gates * (ids == e)).sum(-1)                         # (T,) 0 where not chosen
        h = F.silu(xf.float() @ p["w_gate"][e].float()) * (xf.float() @ p["w_up"][e].float())
        y = y + w[:, None] * (h @ p["w_down"][e].float())
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf)
    return y.view(B, S, D)


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

def _funcol(name: str):
    """A differentiable functional collective, under its newer name where
    this torch has it (``all_gather_single_autograd``), else the older."""
    import torch.distributed._functional_collectives as funcol
    for n in (f"{name}_single_autograd", f"{name}_tensor_autograd"):
        if hasattr(funcol, n):
            return getattr(funcol, n)
    raise AttributeError(f"torch.distributed._functional_collectives has no {name}")


def _wait(t):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(t)


def _on_mesh(t, mesh):
    """A DTensor as it is; a plain tensor (the same on every rank) as a
    replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def apply_moe_ep(p, x, cfg, *, mesh, ep_axis: str = "data", batch_axes=("data",),
                 tp_axis: str = "model"):
    """Expert-parallel MoE: tokens move (all-to-all), weights stay resident.
    x: (B, S, D), a DTensor on ``mesh`` or a plain tensor equal on every
    rank -> (y, aux_loss) as DTensors.

    Requires n_experts · expert_shards == mesh[ep_axis] (dbrx's 16 experts
    on the 16-way data axis).  The reference's layout:

      * x arrives sequence-sharded over the tp axis (the residual's
        layout), so each (data, model) rank dispatches only its own
        S-chunk, with a capacity C = max(K, ceil(S_loc·K·cf/E)) a row;
      * token blocks all-to-all over the expert axis to the expert owner;
      * the owner all-gathers tokens over tp, runs the F-tensor-parallel
        expert FFN, and reduce-scatters the partial outputs back to each
        tp rank's own token chunk;
      * blocks all-to-all back and combine locally.

    Routing and the aux loss are computed on the whole DTensor, as the
    reference computes them outside its ``shard_map``.  Each collective's
    result is waited on before it is used."""
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    E, K, cf, ksh = cfg.n_experts, cfg.top_k, cfg.capacity_factor, cfg.expert_shards
    Ev = E * ksh
    ms = mesh_shape(mesh)
    if Ev != ms.get(ep_axis):
        raise ValueError(f"apply_moe_ep: {Ev} virtual experts on a {ep_axis} axis of "
                         f"{ms.get(ep_axis)}")
    M = ms.get(tp_axis, 1)
    dtype = x.dtype
    x = _on_mesh(x, mesh)
    ids, gates, probs = _route(_on_mesh(p["router"], mesh), x, K)
    aux = _aux_loss(ids, probs, cfg)

    bspec = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
    seq = tp_axis if (S % M == 0 and tp_axis in ms) else None
    act = placements(P(bspec, seq, None), mesh)
    tp = tp_axis if tp_axis in ms else None
    w_in = placements(P(ep_axis, None, tp), mesh)
    w_out = placements(P(ep_axis, tp, None), mesh)
    ep_group = mesh.get_group(ep_axis)
    tp_group = mesh.get_group(tp_axis) if tp else None
    all_to_all, all_gather, reduce_scatter = (
        _funcol("all_to_all"), _funcol("all_gather"), _funcol("reduce_scatter"))

    def local_fn(xb, idb, gtb, wg, wu, wd):
        # xb: (B_loc, S_loc, D); wg/wu: (1, D, F_loc); wd: (1, F_loc, D)
        Bl, Sl, _ = xb.shape
        C = max(K, int(math.ceil(Sl * K * cf / E)))
        dispatch, combine = _dispatch_combine(idb, gtb, E, C, ksh)
        send = torch.einsum("bsd,bsec->ebcd", xb, dispatch.to(xb.dtype))
        recv = _wait(all_to_all(send.contiguous(), None, None, ep_group))   # (E_src,Bl,C,D)
        toks = recv if tp_group is None else _wait(all_gather(recv, 0, tp_group))
        flat = toks.reshape(-1, D)                                     # (M·E·Bl·C, D)
        h = F.silu(flat @ wg[0]) * (flat @ wu[0])                      # F_loc columns
        out = (h @ wd[0]).reshape((toks.shape[0],) + recv.shape[1:])   # partial over tp
        red = out if tp_group is None else _wait(reduce_scatter(out, "sum", 0, tp_group))
        back = _wait(all_to_all(red.to(xb.dtype).contiguous(), None, None, ep_group))
        return (torch.einsum("ebcd,bsec->bsd", back, combine.to(xb.dtype)),)

    fn = local_map(local_fn, out_placements=(act,),
                   in_placements=(act, act, act, w_in, w_in, w_out),
                   device_mesh=mesh, redistribute_inputs=True)
    w = [_on_mesh(p[k], mesh).to(dtype) for k in ("w_gate", "w_up", "w_down")]
    return fn(x, ids, gates, *w)[0], aux


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
