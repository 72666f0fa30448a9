"""Plain float32 forward of granite-4.0-h (HF ``GraniteMoeHybrid``), on one
card's share of the experts.

Equations, per layer i, as HF's ``GraniteMoeHybridDecoderLayer`` states
them: x += r · mixer(RMSNorm_1(x)), then with h = RMSNorm_2(x),
x += r · (moe(h) + shared(h)); r is ``residual_multiplier``.  The mixer is
attention at the layers ``attn_layers`` and Mamba2 elsewhere:

- Mamba2: [z | xBC | dt] = h W_in; xBC = silu(causal depthwise conv(xBC)
  + b); x, B, C split from xBC (one group: every head shares B and C);
  dt = softplus(dt + dt_bias), A = -exp(A_log); per head, from a zero
  state, the sequential recurrence h_t = e^(dt_t A) h_(t-1) + dt_t x_t B_t^T,
  y_t = h_t C_t + D x_t (not the chunked form); out = RMSNorm(y · silu(z))
  W_out (the gated norm over the whole inner width).
- attention: GQA with no position embedding (NoPE), scores scaled by
  ``attention_multiplier`` (1/128), causal softmax.
- moe: softmax over the top-k router logits of all ``n_experts`` (HF's
  ``GraniteMoeHybridTopKGating``), each held expert's SwiGLU
  W_down (silu(W_gate h) · W_up h) weighted by its gate, in a loop over
  the held experts; shared: one SwiGLU of width ``shared_expert_ff``.

The embedding is the table's rows times ``embedding_multiplier``; the head
the tied table after the final RMSNorm, divided by ``logits_scaling``
(taken in ``hidden``).

Departures from HF's model: every RMSNorm scale (the gated one too) is
stored zero-centred, applied as (1 + scale), as the program's parameter
tree lays it out; weights are (in, out); the experts are those this card
holds (experts 0 .. experts_held - 1 of the router's n_experts), the
others' part left out, as in the program: the result is this card's share
plus the shared expert.  No kernel, no cache, no batching across prompts
beyond the block.  Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ref_common import Precision, rms_norm


def _swiglu(h, w_gate, w_up, w_down, pr: Precision):
    return pr.mm(F.silu(pr.mm(h, w_gate)) * pr.mm(h, w_up), w_down)


def _mamba2(mp, h, sz, pr: Precision):
    b, S, d = h.shape
    d_in, H, N = sz["ssm_expand"] * d, sz["ssm_heads"], sz["ssm_state"]
    P = d_in // H
    zxbcdt = pr.mm(h, mp["in_proj"])
    z, xbc, dt = zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N], zxbcdt[..., 2 * d_in + 2 * N:]
    w = mp["conv_w"]                                          # (taps, channels)
    taps = w.shape[0]
    pad = torch.cat([xbc.new_zeros(b, taps - 1, xbc.shape[-1]), xbc], dim=1)
    conv = sum(pad[:, j:j + S] * w[j] for j in range(taps)) + mp["conv_b"]
    xbc = F.silu(conv)
    x = xbc[..., :d_in].reshape(b, S, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    dt = F.softplus(dt + mp["dt_bias"])                        # (b, S, H)
    A = -torch.exp(mp["A_log"])
    state = torch.zeros(b, H, P, N, dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(pr.einsum("bhpn,bn->bhp", state, Cm[:, t]) + mp["D"][:, None] * x[:, t])
    y = torch.stack(ys, dim=1).reshape(b, S, d_in)
    y = rms_norm(y * F.silu(z), mp["norm"], sz["norm_eps"])
    return pr.mm(y, mp["out_proj"])


def _attention(a, h, sz, pr: Precision):
    b, S, _ = h.shape
    H, KV, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    q = pr.mm(h, a["wq"]).view(b, S, H, hd)
    k = pr.mm(h, a["wk"]).view(b, S, KV, hd).repeat_interleave(H // KV, dim=2)
    v = pr.mm(h, a["wv"]).view(b, S, KV, hd).repeat_interleave(H // KV, dim=2)
    s = pr.einsum("bqhd,bkhd->bhqk", q, k) * sz["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = pr.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return pr.mm(o.reshape(b, S, H * hd), a["wo"])


def _moe(mp, h, sz, pr: Precision):
    """The held experts' part (top-k over all n_experts) plus the shared
    expert."""
    b, S, d = h.shape
    x = h.reshape(-1, d)
    top, ids = torch.topk(pr.mm(x, mp["router"]), sz["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in range(sz["experts_held"]):
        w = (gates * (ids == e)).sum(-1)
        rows = torch.nonzero(w).flatten()
        if len(rows):
            y[rows] += w[rows, None] * _swiglu(x[rows], mp["w_gate"][e], mp["w_up"][e],
                                               mp["w_down"][e], pr)
    sh = mp["shared"]
    y = y + _swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], pr)
    return y.view(b, S, d)


def hidden(p, sz, tokens, pr: Precision):
    """Final-normed hidden states (b, S, d_model) of prompts ``tokens`` (b,
    S), over ``logits_scaling``: ``head`` takes no sizes, and the head is
    linear, so the logits' division is taken here (by 16, a power of two:
    exact)."""
    eps, r = sz["norm_eps"], sz["residual_multiplier"]
    x = p["embed"]["table"][tokens.long()].float() * sz["embedding_multiplier"]
    for i, bp in enumerate(p["blocks"]):
        h = rms_norm(x, bp["ln1"]["scale"], eps)
        if i in sz["attn_layers"]:
            x = x + r * _attention(bp["attn"], h, sz, pr)
        else:
            x = x + r * _mamba2(bp["mamba"], h, sz, pr)
        x = x + r * _moe(bp["moe"], rms_norm(x, bp["ln2"]["scale"], eps), sz, pr)
    return rms_norm(x, p["final_norm"]["scale"], eps) / sz["logits_scaling"]


def head(p, h, pr: Precision):
    """The tied table's product (``hidden`` has divided by logits_scaling)."""
    return pr.mm(h, p["embed"]["table"].T)
