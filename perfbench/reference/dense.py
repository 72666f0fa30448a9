"""Plain float32 forward of a dense decoder (qwen1.5-4b's family).

Equations, as the JAX package's ``models/transformer.py``,
``models/attention.py``, ``models/rope.py`` and ``models/layers.py`` state
them, per block: x += Wo · attn(RoPE(Wq h + bq), RoPE(Wk h + bk), Wv h + bv)
with h = RMSNorm(x), causal softmax attention over all earlier positions
(GQA: each kv head serves n_heads / n_kv_heads query heads);
x += W_down (silu(W_gate h) * W_up h) with h = RMSNorm(x).  RMSNorm's scale
is stored zero-centred (1 + scale); RoPE rotates the two halves of each
head at frequencies theta^(-2i / head_dim).  The embedding is a row lookup
and the head a product with ``head.w`` after the final RMSNorm.  No
kernel, no cache, no batching across prompts beyond the block: each
prompt's positions 0..S-1 attend only to themselves.

The parameter tree is the benchmark's (``harness/weights.py``), laid out
as the program's ``abstract_params`` names it.  Imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch

from ref_common import Precision, rms_norm


def _rope(x, theta):
    """x: (b, S, H, hd), positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    i = torch.arange(hd // 2, dtype=torch.float64, device=x.device)
    freqs = (theta ** (-2.0 * i / hd)).float()
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs   # (S, hd/2)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, pr: Precision):
    """Causal softmax attention, float32. q (b,S,H,hd), k/v (b,S,KV,hd)."""
    b, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = pr.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return pr.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def hidden(p, sz, tokens, pr: Precision):
    """Final-normed hidden states (b, S, d_model) of prompts ``tokens`` (b, S)."""
    H, KV, hd, eps = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"], sz["norm_eps"]
    x = p["embed"]["table"][tokens.long()].float()
    b, S, _ = x.shape
    for bp in p["blocks"]:
        a = bp["attn"]
        h = rms_norm(x, bp["ln1"]["scale"], eps)
        q, k, v = pr.mm(h, a["wq"]), pr.mm(h, a["wk"]), pr.mm(h, a["wv"])
        if sz["qkv_bias"]:
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        q = _rope(q.view(b, S, H, hd), sz["rope_theta"])
        k = _rope(k.view(b, S, KV, hd), sz["rope_theta"])
        o = _attention(q, k, v.view(b, S, KV, hd), pr)
        x = x + pr.mm(o.reshape(b, S, H * hd), a["wo"])
        f = bp["ffn"]
        h = rms_norm(x, bp["ln2"]["scale"], eps)
        x = x + pr.mm(torch.nn.functional.silu(pr.mm(h, f["w_gate"])) * pr.mm(h, f["w_up"]),
                      f["w_down"])
    return rms_norm(x, p["final_norm"]["scale"], eps)


def head(p, h, pr: Precision):
    return pr.mm(h, p["head"]["w"])
