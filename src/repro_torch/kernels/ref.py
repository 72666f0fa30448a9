"""Plain PyTorch versions of the kernels (exact, unchunked).

They compute what ``csrc/attention.cu``, ``csrc/scan.cu`` and
``csrc/moe.cu`` compute, in float32; attention uses the same finite ``NEG_INF`` mask, and the scans are
the exact step-by-step recurrences, with an initial state.  ``gemm_ref``
repeats ``csrc/gemm.cu``'s arithmetic: the TF32 split, three products a
stage and float32 sums in the kernel's order.  The CPU path
of the wrappers runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Counterpart of the JAX package's
``kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """Naive quadratic attention. q: (B,S,H,hd); k: (B,Skv,KV,hd); v:
    (B,Skv,KV,hdv), hdv v's own width (MLA's 128 beside a q.k width of 192);
    query i and key j at positions i and j."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    qi = torch.arange(S, device=q.device)[:, None]
    si = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= si <= qi
    if window is not None:
        mask &= si > qi - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return o.reshape(B, S, H, v.shape[3]).to(q.dtype)


def decode_attention_ref(q, k, v, q_positions, kv_positions, *,
                         window: Optional[int] = None):
    """q: (B,1,H,hd); k,v: (B,S,KV,hd); q_positions (B,), kv_positions
    (B,S) absolute positions, -1 for never-written slots.  A row with no
    valid slot gets uniform weights, i.e. mean(V), as in the kernel."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    kp = kv_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, None, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial_ref(q, k, v, q_positions, kv_positions, *,
                                 window: Optional[int] = None):
    """``decode_attention_ref`` over one segment of a cache's slots, with
    what it takes to combine segments: (o (B,1,H,hd) float32, lse (B,H)
    float32), o normalised over the segment and lse the log of its softmax
    denominator, max + log(sum).  A (row, head) with no valid slot in the
    segment gets mean(V) of the segment and lse = NEG_INF."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    kp = kv_positions[:, None, None, :]
    qp = q_positions[:, None, None, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / l[..., None]
    lse = torch.where(m > NEG_INF / 2, m + torch.log(l), NEG_INF)
    return o.reshape(B, 1, H, hd), lse.reshape(B, H)


def rwkv6_ref(r, k, v, logw, u, s0=None):
    """Exact sequential RWKV6 recurrence, one step at a time:
        y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(logw_t)) S + k_t^T v_t
    r, k, v, logw: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd) float32 or None
    (zeros).  Returns (y (B,S,H,hd) float32, final state (B,H,hd,hd))."""
    B, S, H, hd = r.shape
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float().clone())
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]            # (B,H,hd,hd)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t], state + uf * kv))
        state = state * wf[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), state


def ssd_ref(xdt, Bm, Cm, dA, h0=None):
    """Exact sequential SSD (Mamba2) recurrence, scalar decay per head:
        h <- h exp(dA_t) + xdt_t^T B_t,   y_t = h C_t
    xdt: (B,S,H,hd); Bm, Cm: (B,S,H,N); dA: (B,S,H) <= 0; h0: (B,H,hd,N)
    float32 or None (zeros).  Returns (y (B,S,H,hd) float32, final state)."""
    B, S, H, hd = xdt.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, hd, N), dtype=torch.float32, device=xdt.device)
         if h0 is None else h0.float().clone())
    xf, bf, cf = xdt.float(), Bm.float(), Cm.float()
    af = torch.exp(dA.float())
    ys = []
    for t in range(S):
        h = h * af[:, t, :, None, None] + xf[:, t, :, :, None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhdn->bhd", cf[:, t], h))
    return torch.stack(ys, dim=1), h


def moe_experts_ref(x, tok, offsets, gates, pos, w_gate, w_up, w_down):
    """The held experts' part of a dropless MoE layer over rows sorted by
    expert.  x: (T, D); tok, gates: (A,) each sorted assignment's token and
    gate, the rows of held expert e at offsets[e] .. offsets[e + 1] - 1 and
    the rest past offsets[-1]; pos: (T, K) each (token, k) assignment's
    sorted row; w_gate, w_up: (E_held, D, F); w_down: (E_held, F, D).
    Returns y (T, D) float32: sum over k of the token's held assignments of
    gate * W_down^T (silu(W_gate^T x) * W_up^T x), in k order."""
    T, D = x.shape
    A = tok.shape[0]
    off = offsets.tolist()
    o = torch.zeros((A + 1, D), dtype=torch.float32, device=x.device)  # row A: no held expert
    for e in range(len(off) - 1):
        r = slice(off[e], off[e + 1])
        xe = x[tok[r].long()].float()
        h = torch.nn.functional.silu(xe @ w_gate[e].float()) * (xe @ w_up[e].float())
        o[r] = gates[r, None].float() * (h @ w_down[e].float())
    rows = torch.where(pos < off[-1], pos, A).long()
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for k in range(pos.shape[1]):
        y += o[rows[:, k]]
    return y


GEMM_BK = 32      # csrc/gemm.cu's stage depth


def tf32_round(x):
    """x (float32) rounded to TF32, 10 mantissa bits, to nearest with ties
    away from zero: ``common.cuh``'s ``split_tf32`` (bit 12 added, the 13
    low bits cleared; the tensor core reads only the high 19 bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(hi, lo): x's TF32 halves, x - hi exact and lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def gemm_ref(x, w, splits: int = 1):
    """x (T, K) @ w (K, N) as ``csrc/gemm.cu`` takes it, float32: K in
    stages of 32, each stage x_hi w_lo + x_lo w_hi + x_hi w_hi from fresh
    sums, the stages added in float32 one after another, in ``splits``
    parts of K (``gemm.plan``'s) whose sums are added in their order along
    K."""
    K = x.shape[1]
    xh, xl = tf32_split(x.float())
    wh, wl = tf32_split(w.float())
    stages = -(-K // GEMM_BK)
    kps = -(-stages // splits)
    y = None
    for lo in range(0, stages, kps):
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
        for s in range(lo, min(stages, lo + kps)):
            k = slice(s * GEMM_BK, (s + 1) * GEMM_BK)
            acc += xh[:, k] @ wl[k] + xl[:, k] @ wh[k] + xh[:, k] @ wh[k]
        y = acc if y is None else y + acc
    return y
