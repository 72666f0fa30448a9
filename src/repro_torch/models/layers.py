"""Core layers: norms, MLPs, embeddings, parameter init.

Parameters are plain nested dicts of tensors, with the JAX package's
names and layouts (weights stored (in, out), used as ``x @ w``), so a JAX
parameter tree converts leaf for leaf (``models/convert.py``).
Initialisation draws from an explicit ``torch.Generator`` on the target
device; its numbers differ from ``jax.random``'s, so parity tests share
weights through ``convert.params_from_jax`` instead of seeds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, gather_fsdp, gather_inner, gather_inner_grad,
                                              is_dtensor, replicated)
from repro_torch.kernels import gemm


def _dense_init(shape, generator, device, in_axis: int = 0,
                dtype=torch.float32):
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)


def mm(x, w):
    """x @ w, promoted as JAX promotes a product: under the bfloat16 compute
    cast the vectors stay float32, and a float32 operand (an activation a
    vector touched) makes the product float32, the other operand cast up.
    One dtype: a plain product.  On DTensors x's inner leading dims are
    gathered first, and so are those of the product's gradient, and w's
    fsdp shards (``sharding.gather_inner``, ``gather_inner_grad``,
    ``gather_fsdp``).  A float32 product on the card goes to the 3xTF32
    tensor-core kernel where ``kernels.gemm.take``'s shape rule takes it
    (plain tensors, no gradient, T >= 64, K and N >= 128): the served
    projections; the CPU, bfloat16, training and small products stay
    ``x @ w``."""
    x, w = gather_inner(x), gather_fsdp(w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.dtype == torch.float32:
        y = gemm.take(x, w)
        if y is not None:
            return y
    return gather_inner_grad(x @ w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm in float32; the scale is stored zero-centred (1 + scale)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in float32 (scale stored as is, not zero-centred)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(d, device, *, with_bias: bool = False):
    """RMSNorm: a zero-centred scale; LayerNorm (with_bias): scale 1, bias 0."""
    if not with_bias:
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def specs_norm(*, with_bias: bool = False):
    p = {"scale": P(None)}
    if with_bias:
        p["bias"] = P(None)
    return p


def apply_norm(p, x, eps=1e-5):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d, ff, device, act_fn: str = "silu"):
    if act_fn == "silu":
        return {
            "w_gate": _dense_init((d, ff), generator, device),
            "w_up": _dense_init((d, ff), generator, device),
            "w_down": _dense_init((ff, d), generator, device),
        }
    return {
        "w_up": _dense_init((d, ff), generator, device),
        "b_up": torch.zeros((ff,), dtype=torch.float32, device=device),
        "w_down": _dense_init((ff, d), generator, device),
        "b_down": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def specs_mlp(act_fn: str = "silu"):
    if act_fn == "silu":
        return {"w_gate": P("fsdp", "tp"), "w_up": P("fsdp", "tp"),
                "w_down": P("tp", "fsdp")}
    return {"w_up": P("fsdp", "tp"), "b_up": P("tp"),
            "w_down": P("tp", "fsdp"), "b_down": P(None)}


def apply_mlp(p, x, act_fn: str = "silu"):
    if act_fn == "silu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
        return mm(h, p["w_down"])
    # jax.nn.gelu, which the JAX package calls, is the tanh approximation
    # by default; torch's default is the exact erf form
    h = F.gelu(mm(x, p["w_up"]) + p["b_up"], approximate="tanh")
    return mm(h, p["w_down"]) + p["b_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab, d, device):
    return {"table": _dense_init((vocab, d), generator, device, in_axis=1)}


def specs_embedding():
    return {"table": P("tp", "fsdp")}


def embed(p, tokens):
    """The table's rows of ``tokens``.  A table sharded over its rows is
    never gathered: each rank looks the tokens up in its own rows, zeros
    where it holds none, and the rows sum over the mesh dim of the
    vocabulary (an all-reduce of (B, S, d)), as GSPMD partitions a gather
    on a sharded operand.  For tokens sharded over a mesh beside a table
    whole in its rows, an embedding over the gathered table (the same
    rows: DTensor's rule for the indexing's backward, an index_put with
    sharded indices, fails in torch 2.11)."""
    table = p["table"]
    if _vocab_mesh_dim(table) is not None:
        return _embed_on_vocab_shards(table, tokens)
    if is_dtensor(tokens) and not all(pl.is_replicate() for pl in tokens.placements):
        return F.embedding(tokens, replicated(table))
    return table[tokens]


def _vocab_mesh_dim(table):
    """The one mesh dim that shards a DTensor table's rows, else None."""
    if not is_dtensor(table):
        return None
    dims = [i for i, pl in enumerate(table.placements) if pl.is_shard(0)]
    return dims[0] if len(dims) == 1 else None


def _embed_on_vocab_shards(table, tokens):
    """``embed`` on a table whose rows one mesh dim shards (``local_map``):
    the output is partial over that dim.  The table's gradient is a rank's
    own tokens' rows: partial over the mesh dims that shard the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, dim = table.device_mesh, _vocab_mesh_dim(table)
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lo = mesh.get_coordinate()[dim] * -(-table.shape[0] // mesh.size(dim))
    # tokens flattened: DTensor gives a local output's size-1 dims strides
    # that no product can fold (torch.matmul would copy its weight a row)
    flat = tokens.reshape(-1)
    tok = [Replicate() if i == dim else pl for i, pl in enumerate(flat.placements)]
    rows = [pl if i == dim else Replicate() for i, pl in enumerate(table.placements)]
    rows_grad = [pl if i == dim else Partial() if t.is_shard() else Replicate()
                 for i, (pl, t) in enumerate(zip(table.placements, tok))]

    # indexing, as the plain path: its backward accumulates a token's rows
    # as that path's does (F.embedding's CUDA backward rounds a bf16 table's
    # repeated rows otherwise)
    def local(t, ids):
        ids = ids.long() - lo
        hit = (ids >= 0) & (ids < t.shape[0])
        return t[ids.clamp(0, t.shape[0] - 1)] * hit[..., None].to(t.dtype)
    out = local_map(local, out_placements=([Partial() if i == dim else pl
                                            for i, pl in enumerate(tok)],),
                    in_placements=(rows, tok), in_grad_placements=(rows_grad, tok),
                    device_mesh=mesh, redistribute_inputs=True)(table, flat)
    return out.reshape(tuple(tokens.shape) + (table.shape[1],))


def init_head(generator, d, vocab, device):
    return {"w": _dense_init((d, vocab), generator, device)}


def specs_head():
    return {"w": P("fsdp", "tp")}


# ---------------------------------------------------------------------------
# Positional encodings (whisper-style sinusoidal)
# ---------------------------------------------------------------------------

def sinusoidal_positions(n_pos: int, d: int, offset=0, device=None):
    """(n_pos, d) float32 table [sin | cos] of positions offset..offset+n_pos-1.
    The frequencies divide by max(d // 2 - 1, 1), not d // 2, as the JAX
    package does."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device) + offset
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    inv = torch.exp(-math.log(10_000.0) * dim / max(d // 2 - 1, 1))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never holds the (B, S, V) logits whole)
# ---------------------------------------------------------------------------

def _ce_chunks(S: int, chunk: int) -> int:
    """The JAX package's chunk count: S // chunk, cut until it divides S."""
    n = max(1, S // chunk)
    while S % n:
        n -= 1
    return n


def _is_label(logits, labels):
    """(..., V) bool: each row's label column."""
    return torch.arange(logits.shape[-1], device=logits.device) == labels[..., None]


class _ChunkedCrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy, chunk by chunk over the sequence, logits in
    float32.  The forward keeps no logits; the backward recomputes each
    chunk's (B, s, V) logits, so one chunk's live at a time in both.
    ``hint``, if given, lays out each chunk's logits (a sharding hint).  On
    DTensors, whose vocabulary may be sharded, the gold logit is a masked
    sum over the vocabulary and its gradient a masked subtraction (the same
    values as the gather and scatter, which DTensor shards only through
    data-dependent masks)."""

    @staticmethod
    def forward(ctx, x, table, labels, n, hint=None):
        ctx.save_for_backward(x, table, labels)
        ctx.n, ctx.hint = n, hint or (lambda t: t)
        with torch.profiler.record_function("cross_entropy.forward"):
            tf = gather_fsdp(table).float()
            total = x.new_zeros((), dtype=torch.float32)
            for xc, lc in zip(x.chunk(n, dim=1), labels.chunk(n, dim=1)):
                logits = ctx.hint(gather_inner(xc.float()) @ tf.T)
                if is_dtensor(logits):
                    gold = torch.where(_is_label(logits, lc), logits, 0.0).sum(-1)
                else:
                    gold = logits.gather(-1, lc[..., None].long())[..., 0]
                total = total + (torch.logsumexp(logits, dim=-1) - gold).sum()
        return total / labels.numel()

    @staticmethod
    def backward(ctx, grad):
        x, table, labels = ctx.saved_tensors
        with torch.profiler.record_function("cross_entropy.backward"):
            tf = gather_fsdp(table).float()
            scale = grad / labels.numel()
            gx, gt = [], torch.zeros_like(tf)
            for xc, lc in zip(x.chunk(ctx.n, dim=1), labels.chunk(ctx.n, dim=1)):
                xf = gather_inner(xc.float())
                g = torch.softmax(ctx.hint(xf @ tf.T), dim=-1)   # d(lse - gold)/d logits
                if is_dtensor(g):
                    g = g - _is_label(g, lc).to(g.dtype)
                else:
                    g.scatter_add_(-1, lc[..., None].long(), -torch.ones_like(g[..., :1]))
                g.mul_(scale)
                gx.append((g @ tf).to(x.dtype))
                if is_dtensor(gt):      # in place, its layout could not change
                    gt = gt + g.flatten(0, 1).T @ xf.flatten(0, 1)
                else:
                    gt.addmm_(g.flatten(0, 1).T, xf.flatten(0, 1))
        return torch.cat(gx, dim=1), gt.to(table.dtype), None, None, None


def chunked_cross_entropy(x, table, labels, *, chunk: int = 512, constrain_logits=None):
    """Mean token cross-entropy (float32 scalar) over sequence chunks, the
    JAX package's ``chunked_cross_entropy``: x (B, S, D) final hidden
    states, table (V, D) the unembedding, labels (B, S) int;
    ``constrain_logits`` lays out each chunk's logits (the logits hint)."""
    return _ChunkedCrossEntropy.apply(x, table, labels, _ce_chunks(x.shape[1], chunk),
                                      constrain_logits)
