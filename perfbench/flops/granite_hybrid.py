"""Operations and bytes of one prefill pass of granite-4.0-h on one card's
share of the experts, from the configuration's shapes and the pass's real
rows.

``pass_counts(sz, rows, seq)`` -> {group: (flops, bytes)} for the groups
the trace reads (``matmul``, ``flash_attention``, ``ssd_scan``), ``moe``
(the grouped expert kernel alone) and ``total`` (the useful flops of the
whole pass; its bytes those of matmul, flash_attention and ssd_scan).  Two
flops a multiply-add; float32, four bytes a number; each input read once
and each output written once.

- ``matmul``: every product: each Mamba2 layer's in and out projections,
  each attention layer's Q, K, V and O, every layer's router (all
  ``n_experts`` outputs), shared expert and held experts, and the tied head
  on the last position of each prompt.  The held experts' rows are
  counted at their expected number, T·K·held/E (the router spreads the
  T = rows·seq tokens' K choices evenly in expectation): the grouped
  kernel's name holds ``gemm``, so the trace counts its time with the
  products.
- ``moe``: the grouped kernel alone (``moe_gemm_kernel``): the held
  experts' three products at the same rows; its bytes the held experts'
  weights, the tokens' rows read, the SwiGLU's rows written and read back
  and the gate-weighted rows written.
- ``flash_attention``: the attention layers' QK^T and PV over the causal
  (q, k) pairs, as ``flops/dense.py``.
- ``ssd_scan``: the Mamba2 layers' recurrence, the state's read-out C·S
  and rank-1 update xdt^T B per step and head (``chip_smoke.time_ssd``'s
  count); its bytes x·dt in, y out, B and C in group form, dA, and the
  state in and out.
"""
from __future__ import annotations

F32 = 4


def _product(T, n_in, n_out):
    """(flops, bytes) of a (T, n_in) x (n_in, n_out) product."""
    return 2 * T * n_in * n_out, F32 * (T * n_in + n_in * n_out + T * n_out)


def _sum(parts):
    return sum(f for f, _ in parts), sum(b for _, b in parts)


def pass_counts(sz, rows: int, seq: int):
    d, V, L = sz["d_model"], sz["vocab_size"], sz["n_layers"]
    H, KV, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    E, held, K, F, Fs = (sz["n_experts"], sz["experts_held"], sz["top_k"], sz["d_ff"],
                         sz["shared_expert_ff"])
    d_in, Hs, N = sz["ssm_expand"] * d, sz["ssm_heads"], sz["ssm_state"]
    P = d_in // Hs
    n_attn = len(sz["attn_layers"])
    n_mamba = L - n_attn
    T = rows * seq
    R = T * K * held / E                       # held experts' rows, expected
    experts = [_product(R, d, F), _product(R, d, F), _product(R, F, d)]
    mamba = _sum([_product(T, d, 2 * d_in + 2 * N + Hs), _product(T, d_in, d)])
    attn = _sum([_product(T, d, H * hd), _product(T, d, KV * hd), _product(T, d, KV * hd),
                 _product(T, H * hd, d)])
    ffn = _sum([_product(T, d, E), _product(T, d, Fs), _product(T, d, Fs), _product(T, Fs, d)]
               + experts)
    head = _product(rows, d, V)
    mm_f = n_mamba * mamba[0] + n_attn * attn[0] + L * ffn[0] + head[0]
    mm_b = n_mamba * mamba[1] + n_attn * attn[1] + L * ffn[1] + head[1]
    moe_f = L * sum(f for f, _ in experts)
    moe_b = L * F32 * (3 * held * d * F + R * d + 2 * R * F + R * d)
    pairs = seq * (seq + 1) // 2
    fa_f = n_attn * 4 * hd * pairs * rows * H
    fa_b = n_attn * F32 * (2 * rows * seq * H * hd + 2 * rows * seq * KV * hd)
    sc_f = n_mamba * T * Hs * 4 * P * N
    sc_b = n_mamba * F32 * (2 * T * Hs * P + 2 * T * N + T * Hs + 2 * rows * Hs * P * N)
    return {"matmul": (mm_f, mm_b), "flash_attention": (fa_f, fa_b), "ssd_scan": (sc_f, sc_b),
            "moe": (moe_f, moe_b), "total": (mm_f + fa_f + sc_f, mm_b + fa_b + sc_b)}


def launches(sz):
    """The port's kernel launches a pass: flash_attention once an attention
    layer, ssd_scan once a Mamba2 layer."""
    n_attn = len(sz["attn_layers"])
    return {"flash_attention": n_attn, "ssd_scan": sz["n_layers"] - n_attn}
