"""RWKV6 "Finch" block: data-dependent decay linear attention.
[arXiv:2404.05892]

Counterpart of the JAX package's ``models/rwkv.py`` for serving.  Time-mix:
data-dependent token shift (ddlerp with low-rank adjustments), per-channel
decay w_t = exp(-exp(w0 + lora(x))) clamped to ``LOGW_CLAMP``, and bonus u;
the recurrence

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t

goes through the ``rwkv6_scan`` kernel over the prompt (CUDA on the card,
its plain version on the CPU) and through plain tensor ops for a decode
step.  Channel-mix: squared-ReLU MLP with token shift.

The decode cache is updated in place: the functions write into
``cache.x_tm`` / ``cache.x_cm`` / ``cache.state``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init

LORA_R = 32
DECAY_R = 64
LOGW_CLAMP = -2.0    # per-step decay floor: keeps the scan's chunked
                     # factorisation in float32 range (exp(2 * 32) for Q = 32)


def _dims(cfg):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv6(generator, cfg, device):
    d, ff = cfg.d_model, cfg.d_ff
    H, hd = _dims(cfg)

    def normal(*shape, std=1.0, mean=0.0):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(mean, std, generator=generator)

    half = lambda *shape: torch.full(shape, 0.5, dtype=torch.float32, device=device)
    return {
        # time-mix
        "mu": half(6, d),                      # shift mixes: base, r, k, v, w, g
        "tm_w1": _dense_init((d, 5 * LORA_R), generator, device),
        "tm_w2": normal(5, LORA_R, d, std=0.01),
        "w0": normal(d, mean=-6.0, std=0.3),
        "dw1": _dense_init((d, DECAY_R), generator, device),
        "dw2": normal(DECAY_R, d, std=0.01),
        "u": normal(H, hd, std=0.1),
        "wr": _dense_init((d, d), generator, device),
        "wk": _dense_init((d, d), generator, device),
        "wv": _dense_init((d, d), generator, device),
        "wg": _dense_init((d, d), generator, device),
        "wo": _dense_init((d, d), generator, device),
        "ln_x": torch.ones((d,), dtype=torch.float32, device=device),
        # channel-mix
        "mu_ck": half(d),
        "mu_cr": half(d),
        "cm_k": _dense_init((d, ff), generator, device),
        "cm_v": _dense_init((ff, d), generator, device),
        "cm_r": _dense_init((d, d), generator, device),
    }


@dataclasses.dataclass
class RWKVCache:
    x_tm: torch.Tensor    # (B, d) previous token input (time-mix shift)
    x_cm: torch.Tensor    # (B, d) previous token input (channel-mix shift)
    state: torch.Tensor   # (B, H, hd, hd) recurrent state, float32

    def reset(self):
        for t in (self.x_tm, self.x_cm, self.state):
            t.zero_()


def init_rwkv_cache(batch, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    H, hd = _dims(cfg)
    return RWKVCache(
        x_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        x_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        state=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    )


def _shifted(x, x_prev):
    """(B,S,d) -> previous-token tensor, seeded with x_prev (B,d)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent token shift for r, k, v, w, g: five mixed tensors."""
    dx = xs - x
    base = x + dx * p["mu"][0]
    B_, S = x.shape[0], x.shape[1]
    lora = torch.tanh(base @ p["tm_w1"]).reshape(B_, S, 5, LORA_R)
    adj = torch.einsum("bsfr,frd->bsfd", lora, p["tm_w2"])      # (B,S,5,d)
    return [x + dx * (p["mu"][i + 1] + adj[:, :, i, :]) for i in range(5)]


def _rkvwg(p, x, xs, cfg):
    xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
    H, hd = _dims(cfg)
    B_, S = x.shape[0], x.shape[1]
    r = (xr @ p["wr"]).reshape(B_, S, H, hd)
    k = (xk @ p["wk"]).reshape(B_, S, H, hd)
    v = (xv @ p["wv"]).reshape(B_, S, H, hd)
    g = F.silu(xg @ p["wg"])
    logw = -torch.exp(p["w0"] + torch.tanh(xw @ p["dw1"]) @ p["dw2"])   # (B,S,d) < 0
    logw = torch.clamp(logw, min=LOGW_CLAMP).reshape(B_, S, H, hd)
    return r, k, v, g, logw


def _group_norm(y, scale, H, eps=64e-5):
    """Per-head group norm (ln_x). y: (B,S,H,hd) -> (B,S,H*hd)."""
    B_, S, _, hd = y.shape
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return yn.reshape(B_, S, H * hd) * scale


def time_mix(p, x, cfg, *, x_prev=None, s0=None):
    """Prompt time-mix through the rwkv6_scan kernel.  x: (B,S,d); s0:
    (B,H,hd,hd) or None.  Returns (out, (last x, final state))."""
    H, _ = _dims(cfg)
    xs = _shifted(x, x_prev if x_prev is not None else torch.zeros_like(x[:, 0]))
    r, k, v, g, logw = _rkvwg(p, x, xs, cfg)
    y, s_fin = ops.rwkv6_scan(r, k, v, logw, p["u"], s0=s0)
    y = _group_norm(y.float(), p["ln_x"], H).to(x.dtype)
    return (y * g) @ p["wo"], (x[:, -1, :], s_fin)


def channel_mix(p, x, cfg, *, x_prev=None):
    xs = _shifted(x, x_prev if x_prev is not None else torch.zeros_like(x[:, 0]))
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), x[:, -1, :]


def rwkv6_decode(p, x, cfg, cache: RWKVCache):
    """One-token time-mix, plain tensor ops. x: (B,1,d). Returns (out, cache)."""
    H, _ = _dims(cfg)
    xs = cache.x_tm[:, None, :].to(x.dtype)
    r, k, v, g, logw = _rkvwg(p, x, xs, cfg)
    r1, k1, v1, lw1 = r[:, 0].float(), k[:, 0].float(), v[:, 0].float(), logw[:, 0].float()
    S0 = cache.state
    kv = k1[..., :, None] * v1[..., None, :]                     # (B,H,hd,hd)
    y = torch.einsum("bhd,bhde->bhe", r1, S0 + p["u"][None, :, :, None] * kv)
    cache.state.copy_(S0 * torch.exp(lw1)[..., None] + kv)
    y = _group_norm(y[:, None], p["ln_x"], H).to(x.dtype)
    cache.x_tm.copy_(x[:, 0, :])
    return (y * g) @ p["wo"], cache


def channel_mix_decode(p, x, cfg, cache: RWKVCache):
    xs = cache.x_cm[:, None, :].to(x.dtype)
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = torch.square(F.relu(xk @ p["cm_k"]))
    cache.x_cm.copy_(x[:, 0, :])
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), cache
