"""Mamba2 (SSD) block, as used by Zamba2. [arXiv:2405.21060, 2411.15242]

Counterpart of the JAX package's ``models/ssm.py`` for serving: in_proj ->
[z | xBC | dt], causal depthwise conv over xBC, scalar-decay SSD per head,
gated RMSNorm, out_proj.  The prompt's SSD goes through the ``ssd_scan``
kernel (CUDA on the card, its plain version on the CPU); a decode step is
a single state update in plain tensor ops.

B and C stay in group form (B, S, N) (G = 1: all heads share them) and
reach the kernel as a view expanded over the heads, with no copy.  The
decode cache is updated in place: the functions write into
``cache.conv`` and ``cache.ssm``.

A full sequence (a prompt, or a training step) reaches the kernel through
``SSDScan``, whose backward recomputes the scan with ``ssd_chunked``, the
function the JAX package's ``apply_mamba2`` differentiates, and returns
its gradients (the final state's included).  The D skip stays outside.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, mm, rms_norm


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
    G, N = 1, cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    return d_in, heads, G, N, conv_dim


def init_mamba2(generator, cfg, device):
    d = cfg.d_model
    d_in, H, G, N, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=device)
    dt = torch.exp(torch.empty((H,), **f32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator))
    return {
        "in_proj": _dense_init((d, proj_out), generator, device),
        "conv_w": 0.1 * torch.empty((cfg.d_conv, conv_dim), **f32).normal_(generator=generator),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),      # inverse-softplus init
        "norm": torch.zeros((d_in,), **f32),
        "out_proj": _dense_init((d_in, d), generator, device),
    }


def specs_mamba2(cfg):
    del cfg
    return {
        "in_proj": P("fsdp", "tp"),
        "conv_w": P(None, "tp"),
        "conv_b": P("tp"),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "norm": P("tp"),
        "out_proj": P("tp", "fsdp"),
    }


@dataclasses.dataclass
class MambaCache:
    conv: torch.Tensor    # (B, d_conv - 1, conv_dim) trailing inputs
    ssm: torch.Tensor     # (B, H, hd, N) state, float32

    def reset(self):
        self.conv.zero_()
        self.ssm.zero_()


def init_mamba_cache(batch, cfg, dtype=torch.float32, device=None):
    d_in, H, G, N, conv_dim = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, d_in // H, N), dtype=torch.float32, device=device),
    )


def _split_proj(p, x, cfg):
    d_in, H, G, N, conv_dim = _dims(cfg)
    zxbcdt = mm(x, p["in_proj"])
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over a prompt, zero history. xBC: (B,S,C);
    w: (taps, C)."""
    taps, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, taps - 1, 0))
    y = sum(pad[:, i:i + S, :] * w[i] for i in range(taps))
    return F.silu(y + b)


def _ssm_inputs(p, xBC, dt, cfg):
    """xh (B,S,H,hd); Bm, Cm in group form (B,S,N); dt and dA (B,S,H)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    B_, S = xBC.shape[0], xBC.shape[1]
    xh = xBC[..., :d_in].reshape(B_, S, H, d_in // H)
    Bm = xBC[..., d_in:d_in + G * N]
    Cm = xBC[..., d_in + G * N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    dA = dt * -torch.exp(p["A_log"])                       # <= 0
    return xh, Bm, Cm, dt, dA


def ssd_chunked(xh, Bm, Cm, dt, dA, *, q: int = 128, h0=None):
    """Chunked SSD scan, the JAX package's ``ssd_chunked`` without its D
    skip (the caller adds it): xh (B,S,H,hd); Bm, Cm (B,S,N) group form;
    dt, dA (B,S,H) -> (y (B,S,H,hd) float32, final state (B,H,hd,N)
    float32).  Chunks of the largest divisor of S not above S // q, as
    there.  Unlike there, the products run in float32, and the intra-chunk
    decay exp(cum_t - cum_s) is masked before the exp: past the diagonal it
    can overflow, and masking after the exp would turn the gradient there
    into 0 x inf."""
    B_, S, H, hd = xh.shape
    nq = max(1, S // q)
    while S % nq:
        nq -= 1
    Q = S // nq
    lower = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()[None, :, :, None]
    h = (torch.zeros((B_, H, hd, Bm.shape[-1]), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(nq):
        part = slice(i * Q, (i + 1) * Q)
        Bc, Cc = Bm[:, part].float(), Cm[:, part].float()
        xdt = (xh[:, part] * dt[:, part].to(xh.dtype)[..., None]).float()
        cum = dA[:, part].float().cumsum(1)                              # (B,Q,H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]                   # (B,t,s,H)
        L = torch.exp(diff.masked_fill(~lower, float("-inf")))
        scores = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None] * L
        y = torch.einsum("btsh,bshd->bthd", scores, xdt)
        y = y + torch.einsum("btn,bhdn->bthd", Cc, h) * torch.exp(cum)[..., None]
        total = cum[:, -1:, :]
        dh = torch.einsum("bshd,bsn,bsh->bhdn", xdt, Bc, torch.exp(total - cum))
        h = h * torch.exp(total[:, 0])[..., None, None] + dh
        ys.append(y)
    return torch.cat(ys, 1), h


def _ssd_kernel(xh, Bm, Cm, dt, dA, h0):
    """ops.ssd_scan on xdt = xh dt, with B and C expanded over the heads."""
    B_, S, H, _ = xh.shape
    N = Bm.shape[-1]
    xdt = xh * dt.to(xh.dtype)[..., None]
    return ops.ssd_scan(xdt, Bm[:, :, None].expand(B_, S, H, N),
                        Cm[:, :, None].expand(B_, S, H, N), dA, h0=h0)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient, on xh and dt (the kernel reads xdt =
    xh dt) and group-form B and C (expanded over the heads by stride 0).
    Forward: the kernel (its plain version on a CPU tensor); it keeps only
    the inputs and the initial state.  Backward: ``ssd_chunked``
    recomputed and differentiated by autograd, the final state's gradient
    included; no kernel of ``ops`` launches."""

    @staticmethod
    def forward(ctx, xh, Bm, Cm, dt, dA, h0):
        ctx.save_for_backward(xh, Bm, Cm, dt, dA, h0)
        return _ssd_kernel(xh, Bm, Cm, dt, dA, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        with torch.profiler.record_function("ssd_scan.backward"), torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_() for t in saved]
            xh, Bm, Cm, dt, dA, h0 = inputs
            y, h_fin = ssd_chunked(xh, Bm, Cm, dt, dA, h0=h0)
            want = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad((y.to(xh.dtype), h_fin), want,
                                             (grad_y, grad_state)))
        return tuple(None if t is None else next(grads) for t in inputs)


def ssd(xh, Bm, Cm, dt, dA, *, h0=None):
    """Differentiable ``ops.ssd_scan`` (see ``SSDScan``): (y in xh's dtype,
    final state float32).  With grad disabled the kernel's wrapper is
    called directly."""
    if not torch.is_grad_enabled():
        return _ssd_kernel(xh, Bm, Cm, dt, dA, h0)
    return SSDScan.apply(xh, Bm, Cm, dt, dA, h0)


def _mamba2(p, x, cfg, h0=None):
    """in_proj, conv, SSD from ``h0`` (the D skip outside it), gated norm,
    out_proj -> (out, final state, xBC's last d_conv - 1 rows)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    B_, S = x.shape[0], x.shape[1]
    z, xBC, dt = _split_proj(p, x, cfg)
    tail = xBC[:, -(cfg.d_conv - 1):, :]
    xBC = _causal_conv(xBC, p["conv_w"].to(xBC.dtype), p["conv_b"].to(xBC.dtype))
    xh, Bm, Cm, dtf, dA = _ssm_inputs(p, xBC, dt, cfg)
    y, h_fin = ssd(xh, Bm, Cm, dtf, dA, h0=h0)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return mm(y, p["out_proj"]), h_fin, tail


def apply_mamba2(p, x, cfg):
    """Full-sequence block from a zero state (training; the JAX package's
    ``apply_mamba2``). x: (B,S,d) -> (B,S,d)."""
    return _mamba2(p, x, cfg)[0]


def mamba2_prefill(p, x, cfg, cache: MambaCache):
    """Prompt pass from the cache's SSD state; leaves the final state and the
    conv tail in the cache.  x: (B,S,d) -> (out, cache)."""
    out, h_fin, tail = _mamba2(p, x, cfg, cache.ssm)
    cache.conv.zero_()
    cache.conv[:, cache.conv.shape[1] - tail.shape[1]:] = tail
    cache.ssm.copy_(h_fin)
    return out, cache


def mamba2_decode(p, x, cfg, cache: MambaCache):
    """One-step decode, plain tensor ops. x: (B,1,d) -> (out, cache)."""
    d_in, H, G, N, conv_dim = _dims(cfg)
    z, xBC, dt = _split_proj(p, x, cfg)
    window = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)        # (B,d_conv,C)
    y_conv = torch.einsum("btc,tc->bc", window, p["conv_w"].to(xBC.dtype))
    xBC1 = F.silu(y_conv + p["conv_b"].to(xBC.dtype))[:, None, :]       # (B,1,C)
    xh, Bm, Cm, dtf, dA = _ssm_inputs(p, xBC1, dt, cfg)
    xdt = (xh * dtf[..., None])[:, 0]                                   # (B,H,hd)
    decay = torch.exp(dA[:, 0])                                         # (B,H)
    h = cache.ssm * decay[..., None, None] + (
        xdt.float()[..., :, None] * Bm[:, 0].float()[:, None, None, :])
    y = torch.einsum("bn,bhdn->bhd", Cm[:, 0].float(), h)
    y = y + xh[:, 0].float() * p["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    cache.conv.copy_(window[:, 1:, :])
    cache.ssm.copy_(h)
    return mm(y, p["out_proj"]), cache
