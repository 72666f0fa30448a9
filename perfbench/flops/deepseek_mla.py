"""Operations and bytes of one prefill pass of DeepSeek-V2-Lite, from the
configuration's shapes and the pass's real rows.

``pass_counts(sz, rows, seq)`` -> {group: (flops, bytes)} for the groups
the trace reads (``matmul``, ``flash_attention``), ``moe`` (the grouped
expert kernel alone) and ``total`` (the useful flops of the whole pass; its
bytes those of matmul and flash_attention).  Two flops a multiply-add;
float32, four bytes a number; each input read once and each output written
once.

- ``matmul``: every product: each layer's MLA projections (W_q, W_kva,
  W_kvb on the latent, W_o), layer 0's dense SwiGLU, each MoE layer's
  router (all ``n_experts`` outputs), shared SwiGLU and routed experts,
  and the untied head on the last position of each prompt.  The routed
  experts run T·K rows (T = rows·seq tokens, K chosen each) and read every
  expert's weights (the ``moe`` entry): the grouped kernel's name holds
  ``gemm``, so the trace counts its time with the products.
- ``moe``: the grouped kernel alone (``moe_gemm_kernel``): the routed
  experts' three products at T·K rows; its bytes all ``n_experts`` experts'
  weights of each MoE layer (at the cell's rows every expert takes some),
  the tokens' rows read, the SwiGLU's rows written and read back and the
  gate-weighted rows written.
- ``flash_attention``: each layer's QK^T over the q.k width (``head_dim``,
  192) and PV over ``v_head_dim`` (128), over the causal (q, k) pairs; its
  bytes Q, K, V and the output.
"""
from __future__ import annotations

F32 = 4


def _product(T, n_in, n_out):
    """(flops, bytes) of a (T, n_in) x (n_in, n_out) product."""
    return 2 * T * n_in * n_out, F32 * (T * n_in + n_in * n_out + T * n_out)


def _sum(parts):
    return sum(f for f, _ in parts), sum(b for _, b in parts)


def pass_counts(sz, rows: int, seq: int):
    d, V, L, H = sz["d_model"], sz["vocab_size"], sz["n_layers"], sz["n_heads"]
    hd, hv, R = sz["head_dim"], sz["v_head_dim"], sz["kv_lora_rank"]
    n_nope, n_rope = sz["qk_nope_head_dim"], sz["qk_rope_head_dim"]
    E, K, F, Fs, Fd = (sz["n_experts"], sz["top_k"], sz["d_ff"], sz["shared_expert_ff"],
                       sz["dense_d_ff"])
    n_dense = sz["first_dense_layers"]
    n_moe = L - n_dense
    T = rows * seq
    A = T * K                                  # routed rows
    mla = _sum([_product(T, d, H * hd), _product(T, d, R + n_rope),
                _product(T, R, H * (n_nope + hv)), _product(T, H * hv, d)])
    dense = _sum([_product(T, d, Fd), _product(T, d, Fd), _product(T, Fd, d)])
    moe_f = 3 * 2 * A * d * F
    moe_b = F32 * (3 * E * d * F + A * d + 2 * A * F + A * d)
    moe_layer = _sum([_product(T, d, E), _product(T, d, Fs), _product(T, d, Fs),
                      _product(T, Fs, d), (moe_f, moe_b)])
    head = _product(rows, d, V)
    mm_f = L * mla[0] + n_dense * dense[0] + n_moe * moe_layer[0] + head[0]
    mm_b = L * mla[1] + n_dense * dense[1] + n_moe * moe_layer[1] + head[1]
    pairs = seq * (seq + 1) // 2
    fa_f = L * 2 * (hd + hv) * pairs * rows * H
    fa_b = L * F32 * rows * seq * H * (2 * hd + 2 * hv)
    return {"matmul": (mm_f, mm_b), "flash_attention": (fa_f, fa_b),
            "moe": (n_moe * moe_f, n_moe * moe_b), "total": (mm_f + fa_f, mm_b + fa_b)}


def launches(sz):
    """The port's kernel launches a pass: flash_attention once a layer."""
    return {"flash_attention": sz["n_layers"]}
