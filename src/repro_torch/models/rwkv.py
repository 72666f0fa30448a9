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

A full sequence (a prompt, or a training step) reaches the kernel through
``RWKV6Scan``, whose backward recomputes the recurrence with
``wkv_chunked``, the function the JAX package's ``time_mix``
differentiates, and returns its gradients (the final state's included).

The decode cache is updated in place: the functions write into
``cache.x_tm`` / ``cache.x_cm`` / ``cache.state``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P, merge_dims, split_dim
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, mm

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


def specs_rwkv6(cfg):
    del cfg
    return {
        "mu": P(None, None), "tm_w1": P("fsdp", None), "tm_w2": P(None, None, None),
        "w0": P(None), "dw1": P("fsdp", None), "dw2": P(None, None),
        "u": P(None, None),
        "wr": P("fsdp", "tp"), "wk": P("fsdp", "tp"), "wv": P("fsdp", "tp"),
        "wg": P("fsdp", "tp"), "wo": P("tp", "fsdp"), "ln_x": P(None),
        "mu_ck": P(None), "mu_cr": P(None),
        "cm_k": P("fsdp", "tp"), "cm_v": P("tp", "fsdp"), "cm_r": P("fsdp", "tp"),
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
    lora = split_dim(torch.tanh(mm(base, p["tm_w1"])), -1, 5, LORA_R)
    adj = torch.einsum("bsfr,frd->bsfd", lora, p["tm_w2"].to(lora.dtype))   # (B,S,5,d)
    return [x + dx * (p["mu"][i + 1] + adj[:, :, i, :]) for i in range(5)]


def _rkvwg(p, x, xs, cfg):
    xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
    H, hd = _dims(cfg)
    r = split_dim(mm(xr, p["wr"]), -1, H, hd)
    k = split_dim(mm(xk, p["wk"]), -1, H, hd)
    v = split_dim(mm(xv, p["wv"]), -1, H, hd)
    g = F.silu(mm(xg, p["wg"]))
    logw = -torch.exp(p["w0"] + mm(torch.tanh(mm(xw, p["dw1"])), p["dw2"]))   # (B,S,d) < 0
    logw = split_dim(torch.clamp(logw, min=LOGW_CLAMP), -1, H, hd)
    return r, k, v, g, logw


def _group_norm(y, scale, H, eps=64e-5):
    """Per-head group norm (ln_x). y: (B,S,H,hd) -> (B,S,H*hd)."""
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return merge_dims(yn, 2) * scale


def wkv_chunked(r, k, v, logw, u, *, q: int = 32, s0=None):
    """Chunked RWKV6 recurrence in float32, the JAX package's
    ``wkv_chunked``: r, k, v, logw (B,S,H,hd), u (H,hd), s0 (B,H,hd,hd) or
    None -> (y (B,S,H,hd) float32, final state (B,H,hd,hd) float32).

    Intra-chunk scores factor as (r_t exp(cum_{t-1} - cum_Q)) . (k_s
    exp(cum_Q - cum_s)), one (Q,hd) x (hd,Q) product a chunk, with logw
    clamped to LOGW_CLAMP.  Chunks are Q = 32 long and the last one is
    zero-padded (r = k = v = 0 and logw = 0 leave the state as it was), as
    the kernel pads it.  The JAX function instead takes the largest
    divisor of S not above S // 32 chunks, so its chunks can pass 44 steps
    and overflow float32 (exp(2 Q)); at S a multiple of 32 the two agree."""
    B, S, H, hd = r.shape
    pad = -S % q

    def chunks(t):
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, (S + pad) // q, q, H, hd).unbind(1)

    logw = torch.clamp(logw.float(), min=LOGW_CLAMP)        # idempotent guard
    uf = u.float()
    below = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)   # s < t
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    ys = []
    for rc, kc, vc, lwc in zip(chunks(r), chunks(k), chunks(v), chunks(logw)):
        cum = lwc.cumsum(1)                                  # cum_t = sum_{s<=t} lw_s
        cum_prev = cum - lwc
        tot = cum[:, -1:]
        r_f = rc * torch.exp(cum_prev - tot)
        k_f = kc * torch.exp(tot - cum)
        scores = torch.einsum("bthd,bshd->bhts", r_f, k_f).masked_fill(~below, 0.0)
        diag = torch.einsum("bthd,bthd->bht", rc, uf * kc)
        scores = scores + torch.diag_embed(diag)
        y = torch.einsum("bhts,bshe->bthe", scores, vc)
        y = y + torch.einsum("bthd,bhde->bthe", rc * torch.exp(cum_prev), state)
        state = state * torch.exp(tot[:, 0])[..., None] + torch.einsum(
            "bshd,bshe->bhde", k_f, vc)
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], state


class RWKV6Scan(torch.autograd.Function):
    """``rwkv6_scan`` with a gradient.  Forward: the kernel (its plain
    version on a CPU tensor); it keeps only the inputs and the initial
    state.  Backward: ``wkv_chunked`` recomputed and differentiated by
    autograd, the final state's gradient included; no kernel of ``ops``
    launches.  ``logw`` arrives clamped (``_rkvwg``) and ``wkv_chunked``
    clamps it again, so both differentiate the same function."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return ops.rwkv6_scan(r, k, v, logw, u, s0=s0)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        with torch.profiler.record_function("rwkv6_scan.backward"), torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_() for t in saved]
            r, k, v, logw, u, s0 = inputs
            y, s_fin = wkv_chunked(r, k, v, logw, u, s0=s0)
            want = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad((y.to(r.dtype), s_fin), want,
                                             (grad_y, grad_state)))
        return tuple(None if t is None else next(grads) for t in inputs)


def wkv(r, k, v, logw, u, *, s0=None):
    """Differentiable ``ops.rwkv6_scan`` (see ``RWKV6Scan``): (y in r's
    dtype, final state float32).  With grad disabled the kernel's wrapper
    is called directly."""
    if not torch.is_grad_enabled():
        return ops.rwkv6_scan(r, k, v, logw, u, s0=s0)
    return RWKV6Scan.apply(r, k, v, logw, u, s0)


def time_mix(p, x, cfg, *, x_prev=None, s0=None):
    """Full-sequence time-mix (a prompt from ``s0``, or a training step)
    through the rwkv6_scan kernel.  x: (B,S,d); s0: (B,H,hd,hd) or None.
    Returns (out, (last x, final state))."""
    H, _ = _dims(cfg)
    xs = _shifted(x, x_prev if x_prev is not None else torch.zeros_like(x[:, 0]))
    r, k, v, g, logw = _rkvwg(p, x, xs, cfg)
    # under a bfloat16 compute cast logw stays float32 (w0 is a vector);
    # the scan then runs in float32, as the JAX package's wkv_chunked does
    dt = torch.promote_types(r.dtype, logw.dtype)
    y, s_fin = wkv(r.to(dt), k.to(dt), v.to(dt), logw, p["u"].to(dt), s0=s0)
    y = _group_norm(y.float(), p["ln_x"], H).to(x.dtype)
    return mm(y * g, p["wo"]), (x[:, -1, :], s_fin)


def channel_mix(p, x, cfg, *, x_prev=None):
    xs = _shifted(x, x_prev if x_prev is not None else torch.zeros_like(x[:, 0]))
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = torch.square(F.relu(mm(xk, p["cm_k"])))
    return torch.sigmoid(mm(xr, p["cm_r"])) * mm(k, p["cm_v"]), x[:, -1, :]


def apply_rwkv6(p, x, cfg):
    """The time-mix half of a block over a full sequence (the JAX
    package's ``apply_rwkv6``; the caller adds the channel-mix)."""
    return time_mix(p, x, cfg)[0]


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
    return mm(y * g, p["wo"]), cache


def channel_mix_decode(p, x, cfg, cache: RWKVCache):
    xs = cache.x_cm[:, None, :].to(x.dtype)
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = torch.square(F.relu(mm(xk, p["cm_k"])))
    cache.x_cm.copy_(x[:, 0, :])
    return torch.sigmoid(mm(xr, p["cm_r"])) * mm(k, p["cm_v"]), cache
