"""Plain float32 forward of RWKV6 "Finch" (arXiv:2404.05892), step by step.

Equations, as the JAX package's ``models/rwkv.py`` and
``models/transformer.py`` state them, per block:

time mix, on h = LayerNorm_1(x) and its previous token h' (zero before
the first): d = h' - h, base = h + d * mu_0,
(l_r, l_k, l_v, l_w, l_g) = tanh(base W1) split in 5 of rank R,
h_i = h + d * (mu_i + l_i W2_i); r = h_r Wr, k = h_k Wk, v = h_v Wv,
g = silu(h_g Wg), log w = max(-exp(w0 + tanh(h_w D1) D2), clamp); per
head, with the state S (head_dim x head_dim) zero at the start,
y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t = diag(w_t) S_{t-1} + k_t^T v_t;
out = (GroupNorm_heads(y) * ln_x * g) Wo; x += out.

channel mix, on h = LayerNorm_2(x) and its previous token h':
k = relu((h + (h' - h) mu_k) Ck)^2, out = sigmoid((h + (h' - h) mu_r) Cr) * (k Cv);
x += out.

Then RMSNorm (zero-centred scale) and the head.  The recurrence runs one
step at a time here, where the program runs a chunked scan.  The decay's
floor (``logw_clamp``, -2 per step) is the JAX package's, not the
paper's.  Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ref_common import Precision, layer_norm, rms_norm


def _shift(h):
    """The previous token's row, zeros before the first."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


def _time_mix(rp, h, sz, pr: Precision):
    b, S, d = h.shape
    hd, R = sz["rwkv_head_dim"], sz["lora_rank"]
    H = d // hd
    dx = _shift(h) - h
    base = h + dx * rp["mu"][0]
    lora = torch.tanh(pr.mm(base, rp["tm_w1"])).view(b, S, 5, R)
    adj = pr.einsum("bsfr,frd->bsfd", lora, rp["tm_w2"])
    hr, hk, hv, hw, hg = (h + dx * (rp["mu"][i + 1] + adj[:, :, i]) for i in range(5))
    r = pr.mm(hr, rp["wr"]).view(b, S, H, hd)
    k = pr.mm(hk, rp["wk"]).view(b, S, H, hd)
    v = pr.mm(hv, rp["wv"]).view(b, S, H, hd)
    g = F.silu(pr.mm(hg, rp["wg"]))
    logw = -torch.exp(rp["w0"] + pr.mm(torch.tanh(pr.mm(hw, rp["dw1"])), rp["dw2"]))
    w = torch.exp(torch.clamp(logw, min=sz["logw_clamp"])).view(b, S, H, hd)
    u = rp["u"][None, :, :, None]                         # (1, H, hd, 1)
    state = torch.zeros(b, H, hd, hd, dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (b, H, hd, hd)
        ys.append(pr.einsum("bhd,bhde->bhe", r[:, t], state + u * kv))
        state = state * w[:, t, :, :, None] + kv
    y = torch.stack(ys, dim=1)                                # (b, S, H, hd)
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + sz["group_norm_eps"])).reshape(b, S, d) * rp["ln_x"]
    return pr.mm(y * g, rp["wo"])


def _channel_mix(rp, h, pr: Precision):
    dx = _shift(h) - h
    k = torch.square(F.relu(pr.mm(h + dx * rp["mu_ck"], rp["cm_k"])))
    return torch.sigmoid(pr.mm(h + dx * rp["mu_cr"], rp["cm_r"])) * pr.mm(k, rp["cm_v"])


def hidden(p, sz, tokens, pr: Precision):
    """Final-normed hidden states (b, S, d_model) of prompts ``tokens`` (b, S)."""
    eps = sz["norm_eps"]
    x = p["embed"]["table"][tokens.long()].float()
    for bp in p["blocks"]:
        x = x + _time_mix(bp["rwkv"], layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], eps),
                          sz, pr)
        x = x + _channel_mix(bp["rwkv"], layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                                     eps), pr)
    return rms_norm(x, p["final_norm"]["scale"], eps)


def head(p, h, pr: Precision):
    return pr.mm(h, p["head"]["w"])
