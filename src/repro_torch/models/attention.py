"""GQA self-attention with a KV cache (prompt and one-token decode),
cross-attention to an encoder's output, and DeepSeek-V2's multi-head
latent attention (MLA) with its latent cache.

Counterpart of the JAX package's ``models/attention.py`` for the serving
path: GQA, optional QKV bias, qk_norm (per-head RMSNorm on q/k as in
Qwen3), RoPE or M-RoPE (qwen2-vl), sliding windows, a heads-major KV
cache with linear or rolling writes, and whisper's cross-attention (no
rotation, no window, every encoder frame visible).  Attention itself goes
through the kernels: ``flash_attention`` for a prompt, an encoder pass and
a prompt's cross-attention (kv length of its own), ``decode_attention``
for each generated token, against the self cache and against the cross
cache (CUDA kernels on the card, their plain versions on the CPU).

Training differentiates through ``FlashAttention``: its forward is the
``flash_attention`` kernel and its backward recomputes the output through
``full_attention`` (or ``kv_blockwise_attention`` past 4096 positions),
the functions the JAX package's ``attention_forward`` differentiates, and
returns their gradients.  ``attention_forward`` is the full-sequence entry
point of training: self-attention, an encoder's (``causal=False``) and
cross-attention (``x_kv=``).

Unlike the JAX functions, the cache is updated in place: the functions
write into ``cache.k`` / ``cache.v`` / ``cache.pos`` and return the same
object.

MLA (the JAX package has none; ``mla_prefill``, ``mla_decode``): per
token, q = h W_q splits per head into 128 unrotated and 64 rotated
columns; [c | k_pe] = h W_kva, c (512) RMSNorm'd; [k_nope | v] = c W_kvb
per head; q_pe and the one k_pe, shared by every head, turn by YaRN's
table in consecutive pairs.  The prompt runs expanded: K = [k_nope |
k_pe] (192) and V (128) into ``flash_attention`` at the softmax scale
192^-0.5 · m^2 (q pre-multiplied by m^2).  The cache keeps only c and the
rotated k_pe, 576 numbers a token a layer (``LatentCache``), and a decode
step attends in the absorbed form over it: q_nope through W_kvb's K half
against c, plus q_pe · k_pe, then the weights times c through W_kvb's V
half.  That step is batched products and a softmax in plain PyTorch on the
card: no decode kernel (no benchmark cell decodes).  A prompt's spans are
``model.mla.project`` (the projections, the norm, the rotation and the
cache write) and ``model.mla.attend`` (flash and the output projection).
Training does not run MLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import P, is_dtensor, merge_dims, split_dim, unshard_dim
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import _dense_init, mm, rms_norm
from repro_torch.profiling.spans import span

FULL_MAX = 4096     # past this many positions the gradient runs kv-blockwise


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, device):
    if cfg.mla:
        return init_mla(generator, cfg, device)
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _dense_init((d, H * hd), generator, device),
        "wk": _dense_init((d, KV * hd), generator, device),
        "wv": _dense_init((d, KV * hd), generator, device),
        "wo": _dense_init((H * hd, d), generator, device),
    }
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H * hd), zeros(KV * hd), zeros(KV * hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def specs_attention(cfg):
    if cfg.mla:
        return {"wq": P("fsdp", "tp"), "wkv_a": P("fsdp", None), "kv_norm": P(None),
                "wkv_b": P(None, "tp"), "wo": P("tp", "fsdp")}
    p = {"wq": P("fsdp", "tp"), "wk": P("fsdp", "tp"), "wv": P("fsdp", "tp"),
         "wo": P("tp", "fsdp")}
    if cfg.qkv_bias:
        p.update(bq=P("tp"), bk=P("tp"), bv=P("tp"))
    if cfg.qk_norm:
        p.update(q_norm=P(None), k_norm=P(None))
    return p


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _project_q(p, x, cfg):
    B, S, _ = x.shape
    q = mm(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = split_dim(q, -1, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def project_kv(p, x, cfg):
    """K and V of x (B, S, d): (B, S, KV, hd) each.  Also whisper's cross
    K/V of the encoder output, which a prefill projects once a layer."""
    B, S, _ = x.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = split_dim(k, -1, KV, hd)
    v = split_dim(v, -1, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_qkv(p, x, cfg):
    return (_scale_q(_project_q(p, x, cfg), cfg), *project_kv(p, x, cfg))


def _scale_q(q, cfg):
    """q for a score scale of its own (``cfg.attention_multiplier``, granite's
    1/128): pre-scaled by attention_multiplier·sqrt(hd), so that the
    kernels' 1/sqrt(hd) leaves the scores at the multiplier.  Without one,
    q as it is."""
    if cfg.attention_multiplier is None:
        return q
    return q * (cfg.attention_multiplier * math.sqrt(cfg.hd))


def _position_table(cfg, positions, positions_thw=None):
    """The rotation of q and k (``rope.position_table``'s (cos, sin)): RoPE
    at ``positions`` (B, S); M-RoPE at ``positions_thw`` (B, S, 3), or at
    text positions t = h = w = ``positions`` without it; MLA's YaRN over
    its rope columns; None for a model without rotation."""
    if cfg.rope_theta <= 0:
        return None
    if cfg.mla:
        return rope_lib.position_table(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                                       yarn=cfg.yarn)
    if cfg.m_rope:
        if positions_thw is None:
            positions_thw = rope_lib.text_positions_thw(positions)
        return rope_lib.position_table(positions_thw, cfg.hd, cfg.rope_theta,
                                       cfg.m_rope_sections)
    return rope_lib.position_table(positions, cfg.hd, cfg.rope_theta)


def prompt_table(cfg, B: int, S: int, device, positions_thw=None):
    """``_position_table`` of a prompt at positions 0..S-1 (qwen2-vl: at
    ``positions_thw``): the same for every layer, so a prefill builds it
    once and hands it to each attention block."""
    if cfg.rope_theta <= 0:
        return None
    positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return _position_table(cfg, positions, positions_thw)


def _apply_positions(q, k, table):
    """q and k rotated by ``table`` (``_position_table``; None: unrotated)."""
    if table is None:
        return q, k
    return rope_lib.rotate(q, table), rope_lib.rotate(k, table)


# ---------------------------------------------------------------------------
# Full-sequence attention: the functions the gradient differentiates
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(B, Sq, 1, 1, Skv) mask from absolute positions; -1 = unwritten."""
    kvp = kv_pos[:, None, None, None, :]
    qpp = q_pos[:, :, None, None, None]
    mask = kvp >= 0
    if causal:
        mask = mask & (kvp <= qpp)
    if window is not None:
        mask = mask & (kvp > qpp - window)
    return mask


def full_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                   window: Optional[int]):
    """Un-chunked attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd);
    positions (B, S*) int.  Scores and softmax in float32; returns q's
    dtype.  The JAX package's ``full_attention`` (S <= 4096)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = split_dim(q.float() / math.sqrt(hd), 2, KV, H // KV)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    s = torch.where(_mask(q_positions, kv_positions, causal, window), s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return merge_dims(o, 2).to(q.dtype)


def kv_blockwise_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                           window: Optional[int], kv_chunk: int = 1024):
    """Online softmax over kv chunks (the chunk count cut until it divides
    Skv), every query kept whole.  The JAX package's
    ``kv_blockwise_attention``, its path past 4096 positions."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = split_dim(q.float() / math.sqrt(hd), 2, KV, G)
    n = max(1, Skv // kv_chunk)
    while Skv % n:
        n -= 1
    Ck = Skv // n
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    for i in range(n):
        part = slice(i * Ck, (i + 1) * Ck)
        kb, vb = k[:, part].float(), v[:, part].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, kb)
        s = torch.where(_mask(q_positions, kv_positions[:, part], causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return merge_dims(out, 2).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient.  Forward: the kernel (its plain
    version on a CPU tensor); it keeps only q, k, v.  Backward: the output
    recomputed through ``full_attention`` (``kv_blockwise_attention`` when
    S or Skv passes 4096), as the JAX package's ``attention_forward``
    switches, and differentiated by autograd; it launches no kernel of
    ``ops``.  Gradients come back in the inputs' dtypes.  On DTensors the
    recompute runs on each rank's shard (``_recompute_on_mesh``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        B, S, Skv = q.shape[0], q.shape[1], k.shape[1]
        with torch.profiler.record_function("flash_attention.backward"), torch.enable_grad():
            fn = full_attention if S <= FULL_MAX and Skv <= FULL_MAX else kv_blockwise_attention
            if is_dtensor(q):
                return (*_recompute_on_mesh(fn, q, k, v, grad_out, ctx.causal, ctx.window),
                        None, None)
            pos = lambda n: torch.arange(n, device=q.device)[None].expand(B, n)
            grads = _recompute(fn, q, k, v, grad_out, pos(S), pos(Skv), ctx.causal, ctx.window)
        return (*grads, None, None)


def _recompute(fn, q, k, v, grad_out, q_pos, kv_pos, causal, window):
    """Gradients of q, k, v: ``fn``'s output recomputed and differentiated."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v, q_positions=q_pos, kv_positions=kv_pos, causal=causal, window=window)
    return torch.autograd.grad(o, (q, k, v), grad_out)


def _recompute_on_mesh(fn, q, k, v, grad_out, causal, window):
    """``_recompute`` on each rank's shard (``local_map``): the batch rows
    as q has them, every head, and the query rows split over the mesh dims
    that shard no batch, as the JAX package's ``seq_spec`` splits its
    scores (the kernel's forward cannot take such a split: it numbers a
    shard's queries from 0), where they split evenly.  Each rank's query
    positions come with its rows; k and v are whole on it, and their
    gradients are the sum over the query split (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    batch = [isinstance(p, Shard) and p.dim == 0 for p in q.placements]
    if q.shape[0] % math.prod(mesh.size(i) for i, b in enumerate(batch) if b):
        batch = [False] * len(batch)       # an uneven batch split: rows whole instead
    free = [mesh.size(i) for i, b in enumerate(batch) if not b and mesh.size(i) > 1]
    split = q.shape[1] % math.prod(free) == 0
    pick = lambda on_batch, other: tuple(
        Replicate() if mesh.size(i) == 1 else on_batch if b else other if split else Replicate()
        for i, b in enumerate(batch))
    rows, whole = pick(Shard(0), Shard(1)), pick(Shard(0), Replicate())
    pos = lambda n, pl: DTensor.from_local(
        torch.arange(n, device=q.device)[None], mesh, [Replicate()] * mesh.ndim,
        run_check=False).redistribute(mesh, pl)
    q_pos = pos(q.shape[1], pick(Replicate(), Shard(1)))
    kv_pos = pos(k.shape[1], pick(Replicate(), Replicate()))
    run = local_map(lambda *a: _recompute(fn, *a, causal, window),
                    out_placements=(rows, pick(Shard(0), Partial()), pick(Shard(0), Partial())),
                    in_placements=(rows, whole, whole, rows, pick(Replicate(), Shard(1)),
                                   pick(Replicate(), Replicate())),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v, grad_out, q_pos, kv_pos)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Differentiable ``ops.flash_attention`` (see ``FlashAttention``); with
    grad disabled (serving's ``inference_mode``) the kernel's wrapper is
    called directly, without the Function's context."""
    if not torch.is_grad_enabled():
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return FlashAttention.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Decode KV cache, stored heads-major: (B, KV, S_buf, hd), as in the
    JAX package.  The decode kernel reads it through the strided view
    ``k.transpose(1, 2)``."""
    k: torch.Tensor       # (B, KV, S_buf, hd)
    v: torch.Tensor       # (B, KV, S_buf, hd)
    pos: torch.Tensor     # (B,) int32, next absolute position to write
    window: int = 0       # 0 = linear buffer; >0 = rolling SWA buffer

    @property
    def rolling(self) -> bool:
        return self.window > 0


def init_kv_cache(batch, max_len, cfg, *, window: Optional[int] = None,
                  dtype=torch.bfloat16, device=None):
    """window: cap the buffer at the sliding window (rolling writes)."""
    buf = max_len if window is None else min(max_len, window)
    shape = (batch, cfg.n_kv_heads, buf, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        window=0 if window is None else buf,
    )


def _slot_mesh_dim(t):
    """The mesh dim that shards a DTensor cache (B, KV, S_buf, hd) over its
    slots, or None (a plain tensor, or a cache whole in its slots)."""
    if not is_dtensor(t):
        return None
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == 2]
    if len(dims) > 1:
        raise ValueError(f"a cache's slots sharded over mesh dims {dims}: one at most")
    return dims[0] if dims else None


def _slot_offset(t) -> int:
    """This rank's first slot of a DTensor cache (0 unless its slots are
    sharded): shards of ceil(S_buf / n) slots, as DTensor cuts them."""
    dim = _slot_mesh_dim(t)
    if dim is None:
        return 0
    n = t.device_mesh.size(dim)
    return t.device_mesh.get_coordinate()[dim] * -(-t.shape[2] // n)


def _replicated(x, mesh):
    """A 0-d index the same on every rank (all sequences decode in
    lockstep) as a replicated DTensor, without a collective."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x.to_local() if is_dtensor(x) else x, mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def _write_slot_on_mesh(buf_t, new, idx):
    """A DTensor cache (B, KV, S_buf, hd) takes the new column (B, KV, 1,
    hd) at slot ``idx``, each rank into its own shard on plain tensors
    (DTensor's ``index_copy_`` mislabels a cache sharded over its slots):
    one slot's ``index_copy_``, at ``idx`` clamped into the shard, of the
    new column where the rank holds the slot and of the slot's own column
    where it does not."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = buf_t.device_mesh, list(buf_t.placements)
    lo = _slot_offset(buf_t)

    def write(b, n, i):
        j = (i - lo).clamp(0, b.shape[2] - 1).reshape(1).long()
        own = (i >= lo) & (i < lo + b.shape[2])
        b.index_copy_(2, j, torch.where(own, n, b.index_select(2, j)))
    slots = lambda p: isinstance(p, Shard) and p.dim == 2
    local_map(write, out_placements=None,
              in_placements=(pl, [Replicate() if slots(p) else p for p in pl],
                             [Replicate()] * mesh.ndim),
              device_mesh=mesh, redistribute_inputs=True)(buf_t, new, _replicated(idx, mesh))


def update_kv_cache(cache: KVCache, k_new, v_new):
    """Append one token in place. k_new: (B, 1, KV, hd).

    All sequences decode in lockstep, so the write index is one scalar:
    ``pos % buf`` for a rolling buffer, else ``min(max(pos), buf - 1)``.
    It stays on the device (no host sync)."""
    buf = cache.k.shape[2]
    pos0 = cache.pos.max()
    idx = pos0 % buf if cache.rolling else torch.clamp(pos0, max=buf - 1)
    if is_dtensor(cache.k):
        for buf_t, new in ((cache.k, k_new), (cache.v, v_new)):
            _write_slot_on_mesh(buf_t, new.transpose(1, 2).to(buf_t.dtype), idx)
        cache.pos += 1
        return cache
    idx = idx.reshape(1).long()
    cache.k.index_copy_(2, idx, k_new.transpose(1, 2).to(cache.k.dtype))
    cache.v.index_copy_(2, idx, v_new.transpose(1, 2).to(cache.v.dtype))
    cache.pos += 1
    return cache


def cache_kv_positions(cache: KVCache):
    """Absolute position of every buffer slot (rolling-aware). (B, S_buf)
    int32, -1 for slots never written."""
    buf = cache.k.shape[2]
    slots = torch.arange(buf, dtype=torch.int32, device=cache.k.device)
    return _slot_positions(slots, cache.pos, buf, cache.rolling)


def _slot_positions(slots, pos, buf: int, rolling: bool):
    """Absolute positions (B, n) int32 of buffer ``slots`` (n,) of a
    ``buf``-slot cache whose sequences are at ``pos`` (B,); -1 for a
    rolling slot never written."""
    slots = slots[None, :]
    if not rolling:
        return slots.expand(pos.shape[0], slots.shape[1])
    # slot s holds absolute position: the largest p < pos with p % buf == s
    pos = pos[:, None]
    cand = pos - 1 - torch.remainder(pos - 1 - slots, buf)
    return torch.where(cand >= 0, cand, -1).to(torch.int32)


def _valid_positions(kv_pos, pos, rolling: bool):
    """A linear buffer's slots at or past ``pos`` are unwritten (the JAX
    path's kv_valid_len = pos): -1 there."""
    return kv_pos if rolling else torch.where(kv_pos < pos[:, None], kv_pos, -1)


def _decode_on_slot_shards(q, cache: KVCache, q_positions, window):
    """``decode_attention`` over a DTensor cache sharded over its slots,
    without gathering it: each rank runs the partial kernel on its own
    shard at its slots' absolute positions (its slot offset, rolling-aware),
    and ``combine_partials`` joins the ranks with two all-reduces over the
    mesh dim of the slots, as GSPMD splits the reference's softmax.  q
    comes whole in its heads on every rank (gathered over that dim where
    it is head-sharded: B·H·hd elements).  Returns (B, 1, H, hd) in the
    cache's dtype, batch-sharded as the cache and head-sharded over the
    slots' mesh dim where it divides the heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = cache.k.device_mesh, list(cache.k.placements)
    if any(isinstance(p, Shard) and p.dim not in (0, 2) for p in pl):
        raise ValueError(f"a slot-sharded cache of placements {pl}: only its batch and "
                         "slots may shard")
    dim = _slot_mesh_dim(cache.k)
    lo, buf, rolling = _slot_offset(cache.k), cache.k.shape[2], cache.rolling
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    # the output leaves head-sharded over the slots' dim where the heads
    # split evenly: the output projection's rows are sharded so
    H, m = q.shape[2], mesh.size(dim)
    heads = H % m == 0
    h0 = mesh.get_coordinate()[dim] * (H // m)
    out = [Shard(1) if i == dim and heads else p for i, p in enumerate(rows)]

    def local(q, k, v, q_pos, pos):
        n = k.shape[2]
        slots = torch.arange(lo, lo + n, dtype=torch.int32, device=k.device)
        kv_pos = _valid_positions(_slot_positions(slots, pos, buf, rolling), pos, rolling)
        o, lse = ops.decode_attention_partial(q.to(k.dtype), k.transpose(1, 2),
                                              v.transpose(1, 2), q_pos, kv_pos, window=window)
        o = ops.combine_partials(o, lse, n, group=(mesh, dim)).to(k.dtype)[:, 0]
        return o[:, h0:h0 + H // m].contiguous() if heads else o
    # (B, H, hd) out of local_map: DTensor gives a local output's size-1
    # dims strides that no product can fold (torch.matmul would copy wo)
    return local_map(local, out_placements=(out,),
                     in_placements=(rows, pl, pl, rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, cache.k, cache.v, q_positions, cache.pos).unsqueeze(1)


def _store_prefix_kv(cache: KVCache, k, v, S: int) -> KVCache:
    """Write a full prompt's (rotated) K/V into the cache buffer in place;
    slots past the prompt are zeroed, as in the JAX package."""
    buf = cache.k.shape[2]
    take = min(S, buf)
    kw = k[:, -take:].transpose(1, 2)      # (B, KV, take, hd)
    vw = v[:, -take:].transpose(1, 2)
    if cache.rolling and S > buf:
        kw = torch.roll(kw, shifts=S % buf, dims=2)
        vw = torch.roll(vw, shifts=S % buf, dims=2)
    if is_dtensor(cache.k):
        for buf_t, new in ((cache.k, kw), (cache.v, vw)):
            _write_prefix_on_mesh(buf_t, new)
        cache.pos.fill_(S)
        return cache
    cache.k[:, :, :take] = kw
    cache.v[:, :, :take] = vw
    cache.k[:, :, take:] = 0
    cache.v[:, :, take:] = 0
    cache.pos.fill_(S)
    return cache


def _write_prefix_on_mesh(buf_t, new):
    """A DTensor cache (B, KV, S_buf, hd) takes ``new`` (B, KV, take, hd) in
    slots 0..take-1 and zeros past them: the whole buffer is built, laid
    out as the cache and copied shard by shard (DTensor's slice assignment
    on a cache sharded over its slots writes each shard's own first
    slots)."""
    new = unshard_dim(new, 2).to(buf_t.dtype)
    full = torch.cat([new, new.new_zeros(new.shape[:2] + (buf_t.shape[2] - new.shape[2],)
                                         + new.shape[3:])], dim=2)
    buf_t.to_local().copy_(full.redistribute(buf_t.device_mesh, buf_t.placements).to_local())


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def attention_decode(p, x, cfg, cache: KVCache, *, positions_thw=None):
    """One-token decode. x: (B, 1, d). Returns (y, cache).

    q and the new k rotate at ``positions_thw`` where given (qwen2-vl's
    step + mrope_delta); the cache write and the mask use ``cache.pos``."""
    B = x.shape[0]
    positions = cache.pos[:, None].clone()                           # (B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q, k_new = _apply_positions(q, k_new, _position_table(cfg, positions, positions_thw))
    cache = update_kv_cache(cache, k_new, v_new)
    if _slot_mesh_dim(cache.k) is not None:
        o = _decode_on_slot_shards(q, cache, positions[:, 0], cfg.sliding_window)
        return mm(merge_dims(o, 2), p["wo"]), cache
    kv_pos = _valid_positions(cache_kv_positions(cache), cache.pos, cache.rolling)
    # a float32 bias beside bfloat16 matrices (the mesh's serving params)
    # makes q float32: it meets the cache in the cache's dtype
    k, v = (t.transpose(1, 2) for t in (cache.k, cache.v))
    o = ops.decode_attention(q.to(k.dtype), k, v, positions[:, 0], kv_pos,
                             window=cfg.sliding_window)
    return mm(merge_dims(o, 2), p["wo"]), cache


def _prompt_attention(p, x, cfg, *, causal, window=None, positions_thw=None, table=None):
    """Self-attention over a whole sequence: QKV projections, rotation at
    positions 0..S-1 (``table``, the caller's ``prompt_table``, or built
    here without it), flash, output projection.  Returns (out, k, v) with k
    rotated, for a cache to keep."""
    B, S, _ = x.shape
    if table is None:
        table = prompt_table(cfg, B, S, x.device, positions_thw)
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _apply_positions(q, k, table)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return mm(merge_dims(o, 2), p["wo"]), k, v


def attention_prefill(p, x, cfg, cache: KVCache, *, table=None):
    """Prompt pass: one set of QKV projections feeds both the attention
    output and the decode cache.  ``table``: the prefill's ``prompt_table``,
    shared by its layers (without it, text positions 0..S-1).  Returns
    (out, cache)."""
    out, k, v = _prompt_attention(p, x, cfg, causal=True, window=cfg.sliding_window,
                                  table=table)
    return out, _store_prefix_kv(cache, k, v, x.shape[1])


def attention_encoder(p, x, cfg):
    """Bidirectional self-attention over an encoder's frames (no cache):
    every frame sees every frame, with no window."""
    return attention_forward(p, x, cfg, causal=False)


def cross_attention_prefill(p, x, cfg, k, v):
    """A prompt's cross-attention to cross K/V (B, Se, KV, hd): no rotation,
    no window, every frame visible (the kernel takes Se != S)."""
    B, S, _ = x.shape
    q = _project_q(p, x, cfg)
    o = flash_attention(q, k, v, causal=False)
    return mm(merge_dims(o, 2), p["wo"])


def attention_forward(p, x, cfg, *, positions_thw=None, causal: bool = True, x_kv=None):
    """Full-sequence attention (training; the JAX package's
    ``attention_forward``): causal self-attention with the model's window,
    an encoder's (``causal=False``, no window) or cross-attention to
    ``x_kv`` (no rotation, no window, every frame visible)."""
    if x_kv is not None:
        return cross_attention_prefill(p, x, cfg, *project_kv(p, x_kv, cfg))
    window = cfg.sliding_window if causal else None
    return _prompt_attention(p, x, cfg, causal=causal, window=window,
                             positions_thw=positions_thw)[0]


def cross_attention_decode(p, x, cfg, k, v):
    """One token's cross-attention to the cross cache (B, Se, KV, hd).

    The reference masks it only by kv >= 0, every frame visible.  The
    decode kernel's mask is kv position <= q position, so q sits at Se - 1
    and the slots at 0..Se-1: the self cache's position would drop every
    frame past the prompt."""
    B, Se = x.shape[0], k.shape[1]
    q = _project_q(p, x, cfg)
    kv_pos = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)
    q_pos = torch.full((B,), Se - 1, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q.to(k.dtype), k, v, q_pos, kv_pos)
    return mm(merge_dims(o, 2), p["wo"])


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(generator, cfg, device):
    """W_q (d, H·192), W_kva (d, 512 + 64), the latent's zero-centred RMSNorm
    scale, W_kvb (512, H·(128 + 128): each head's k_nope then v), W_o
    (H·128, d).  No q latent and no bias (DeepSeek-V2-Lite)."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    return {"wq": _dense_init((d, H * cfg.hd), generator, device),
            "wkv_a": _dense_init((d, r + cfg.qk_rope_head_dim), generator, device),
            "kv_norm": torch.zeros((r,), dtype=torch.float32, device=device),
            "wkv_b": _dense_init((r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                                 generator, device),
            "wo": _dense_init((H * cfg.v_head_dim, d), generator, device)}


@dataclasses.dataclass
class LatentCache:
    """MLA's decode cache: each token's normed latent c and rotated k_pe,
    (B, S_buf, 512) and (B, S_buf, 64); every head's K and V follow from
    them.  A linear buffer, no window."""
    c: torch.Tensor
    k_pe: torch.Tensor
    pos: torch.Tensor     # (B,) int32, next absolute position to write


def init_latent_cache(batch, max_len, cfg, *, dtype=torch.bfloat16, device=None):
    zeros = lambda n: torch.zeros((batch, max_len, n), dtype=dtype, device=device)
    return LatentCache(c=zeros(cfg.kv_lora_rank), k_pe=zeros(cfg.qk_rope_head_dim),
                       pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def mla_softmax_scale(cfg) -> float:
    """192^-0.5 · m(factor, mscale_all_dim)^2."""
    return rope_lib.yarn_softmax_scale(cfg.rope_factor, cfg.yarn_mscale_all_dim) / math.sqrt(cfg.hd)


def _mla_project(p, x, cfg, table):
    """-> q_nope (B, S, H, 128), q_pe rotated (B, S, H, 64), c normed (B,
    S, 512), k_pe rotated (B, S, 64)."""
    B, S, _ = x.shape
    n = cfg.qk_nope_head_dim
    q = mm(x, p["wq"]).view(B, S, cfg.n_heads, cfg.hd)
    kva = mm(x, p["wkv_a"])
    c = rms_norm(kva[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    q_pe = rope_lib.rotate_pairs(q[..., n:], table)
    k_pe = rope_lib.rotate_pairs(kva[..., None, cfg.kv_lora_rank:], table)[:, :, 0]
    return q[..., :n], q_pe, c, k_pe


def mla_prefill(p, x, cfg, cache: LatentCache, *, table=None):
    """A prompt through MLA in its expanded form: K (B, S, H, 192) of each
    head's k_nope and the shared k_pe, V (B, S, H, 128), flash at
    192^-0.5 · m^2.  Writes c and k_pe to ``cache`` (slots past the prompt
    zeroed).  ``table``: the prefill's ``prompt_table``.  Returns (out,
    cache)."""
    B, S, _ = x.shape
    H, n = cfg.n_heads, cfg.qk_nope_head_dim
    if table is None:
        table = prompt_table(cfg, B, S, x.device)
    with span("model.mla.project"):
        q_nope, q_pe, c, k_pe = _mla_project(p, x, cfg, table)
        kv = mm(c, p["wkv_b"]).view(B, S, H, n + cfg.v_head_dim)
        m2 = rope_lib.yarn_softmax_scale(cfg.rope_factor, cfg.yarn_mscale_all_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        q = q * m2 if m2 != 1.0 else q
        k = torch.cat([kv[..., :n], k_pe[:, :, None].expand(B, S, H, cfg.qk_rope_head_dim)],
                      dim=-1)
        cache.c[:, :S] = c
        cache.k_pe[:, :S] = k_pe
        cache.c[:, S:] = 0
        cache.k_pe[:, S:] = 0
        cache.pos.fill_(S)
    with span("model.mla.attend"):
        o = flash_attention(q, k, kv[..., n:], causal=True)
        return mm(o.reshape(B, S, H * cfg.v_head_dim), p["wo"]), cache


def mla_decode(p, x, cfg, cache: LatentCache):
    """One token through MLA in the absorbed form over the latent cache
    (B, 1, d) -> (out, cache): the new c and k_pe are written at the
    sequences' position, then per head scores = (q_nope W_kvb_k^T) c^T +
    q_pe k_pe^T over the written slots, and the output (softmax · c) W_kvb_v.
    Batched products and a softmax in plain PyTorch, on the card too."""
    B = x.shape[0]
    H, n, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    positions = cache.pos[:, None].clone()                           # (B, 1)
    q_nope, q_pe, c, k_pe = _mla_project(p, x, cfg, _position_table(cfg, positions))
    buf = cache.c.shape[1]
    idx = torch.clamp(cache.pos.max(), max=buf - 1).reshape(1).long()
    cache.c.index_copy_(1, idx, c.to(cache.c.dtype))
    cache.k_pe.index_copy_(1, idx, k_pe.to(cache.k_pe.dtype))
    cache.pos += 1
    w = p["wkv_b"].float().view(r, H, n + cfg.v_head_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w[..., :n])
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cache.c.float())
         + torch.einsum("bhe,bse->bhs", q_pe[:, 0].float(), cache.k_pe.float()))
    valid = torch.arange(buf, device=x.device)[None, None, :] < cache.pos[:, None, None]
    s = torch.where(valid, s * mla_softmax_scale(cfg), NEG_INF)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), cache.c.float())
    o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., n:])
    return mm(o.reshape(B, 1, H * cfg.v_head_dim).to(x.dtype), p["wo"]), cache
