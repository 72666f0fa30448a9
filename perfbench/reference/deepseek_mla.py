"""Plain float32 forward of DeepSeek-V2-Lite (HF ``DeepseekV2ForCausalLM``):
multi-head latent attention with YaRN and DeepSeekMoE.

Equations, per layer, as DeepSeek-V2's ``modeling_deepseek.py`` states
them: x += attn(RMSNorm_1(x)), then x += ffn(RMSNorm_2(x)).

- attn (MLA without a q latent, expanded: K and V built for every head):
  q = h W_q, per head [q_nope (128) | q_pe (64)]; [c | k_pe] = h W_kva,
  c = RMSNorm(c) (512); [k_nope | v] = c W_kvb per head (128 + 128);
  q_pe and k_pe (one 64-wide vector shared by the heads) rotated by YaRN:
  frequencies theta^(-2i/64) blended with those over ``rope_factor`` along
  a linear ramp of i between the bands that turn beta_fast and beta_slow
  times over ``rope_original_max`` positions (floored, ceiled), on
  consecutive pairs (2i, 2i + 1); scores [q_nope | q_pe] · [k_nope | k_pe]
  times 192^-0.5 · m^2, m = 0.1 · yarn_mscale_all_dim · ln(rope_factor) + 1;
  causal softmax; o = (P v) W_o.
- ffn: layers below ``first_dense_layers`` a SwiGLU of ``dense_d_ff``; the
  others the softmax over all ``n_experts`` router logits in float32, the
  greedy top-k, gates the chosen probabilities (not renormalised; the
  routed scaling factor is 1), each expert's SwiGLU of ``d_ff`` weighted by its
  gate in a loop over the experts, plus the shared SwiGLU of
  ``shared_expert_ff`` (the 2 shared experts as one, as HF's
  ``DeepseekV2MoE``).

The embedding is a row lookup; the head an untied product after the final
RMSNorm.

Departures from HF's model: every RMSNorm scale is stored zero-centred,
applied as (1 + scale), as the program's parameter tree lays it out;
weights are (in, out); the softmax scale carries m^2 (DeepSeek's code,
vLLM and transformers' deepseek_v3; transformers 4.57's deepseek_v2 leaves
it out); no q latent, no aux loss.  No kernel, no cache, no batching
across prompts beyond the block.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ref_common import Precision, rms_norm


def _swiglu(h, w_gate, w_up, w_down, pr: Precision):
    return pr.mm(F.silu(pr.mm(h, w_gate)) * pr.mm(h, w_up), w_down)


def _yarn_freqs(sz, device):
    dim, base, factor = sz["qk_rope_head_dim"], sz["rope_theta"], sz["rope_factor"]
    i = torch.arange(0, dim, 2, dtype=torch.float64, device=device)
    extra = 1.0 / base ** (i / dim)

    def band(turns):
        turned = sz["rope_original_max"] / (turns * 2 * math.pi)
        return dim * math.log(turned) / (2 * math.log(base))
    lo = max(math.floor(band(sz["yarn_beta_fast"])), 0)
    hi = min(math.ceil(band(sz["yarn_beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    return (extra / factor * ramp + extra * (1 - ramp)).float()


def _mscale(factor, m):
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def _rotate(x, freqs):
    """x: (b, S, ..., 64) at positions 0..S-1, pairs (2i, 2i+1) at freqs[i]."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs   # (S, 32)
    shape = (1, S) + (1,) * (x.dim() - 3) + (-1,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _mla(a, h, sz, pr: Precision, freqs):
    b, S, _ = h.shape
    H, n, r, R = sz["n_heads"], sz["qk_nope_head_dim"], sz["qk_rope_head_dim"], sz["kv_lora_rank"]
    q = pr.mm(h, a["wq"]).view(b, S, H, n + r)
    kva = pr.mm(h, a["wkv_a"])
    c = rms_norm(kva[..., :R], a["kv_norm"], sz["norm_eps"])
    kv = pr.mm(c, a["wkv_b"]).view(b, S, H, n + sz["v_head_dim"])
    q_pe = _rotate(q[..., n:], freqs)
    k_pe = _rotate(kva[..., R:], freqs)                                  # (b, S, 64)
    scale = _mscale(sz["rope_factor"], sz["yarn_mscale_all_dim"]) ** 2 / math.sqrt(n + r)
    s = (pr.einsum("bqhd,bkhd->bhqk", q[..., :n], kv[..., :n])
         + pr.einsum("bqhd,bkd->bhqk", q_pe, k_pe)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = pr.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), kv[..., n:])
    return pr.mm(o.reshape(b, S, H * sz["v_head_dim"]), a["wo"])


def _moe(mp, h, sz, pr: Precision):
    b, S, d = h.shape
    x = h.reshape(-1, d)
    probs = torch.softmax(pr.mm(x, mp["router"]), dim=-1)
    gates, ids = torch.topk(probs, sz["top_k"], dim=-1)
    if sz["norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(sz["n_experts"]):
        w = (gates * (ids == e)).sum(-1)
        rows = torch.nonzero(ids.eq(e).any(-1)).flatten()
        if len(rows):
            y[rows] += w[rows, None] * _swiglu(x[rows], mp["w_gate"][e], mp["w_up"][e],
                                               mp["w_down"][e], pr)
    sh = mp["shared"]
    return (y + _swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], pr)).view(b, S, d)


def hidden(p, sz, tokens, pr: Precision):
    """Final-normed hidden states (b, S, d_model) of prompts ``tokens`` (b, S)."""
    eps = sz["norm_eps"]
    x = p["embed"]["table"][tokens.long()].float()
    freqs = _yarn_freqs(sz, x.device)
    for i, bp in enumerate(p["blocks"]):
        x = x + _mla(bp["attn"], rms_norm(x, bp["ln1"]["scale"], eps), sz, pr, freqs)
        h = rms_norm(x, bp["ln2"]["scale"], eps)
        if i < sz["first_dense_layers"]:
            f = bp["ffn"]
            x = x + _swiglu(h, f["w_gate"], f["w_up"], f["w_down"], pr)
        else:
            x = x + _moe(bp["moe"], h, sz, pr)
    return rms_norm(x, p["final_norm"]["scale"], eps)


def head(p, h, pr: Precision):
    return pr.mm(h, p["head"]["w"])
