"""Operations and bytes of one prefill pass of a dense decoder, from the
configuration's shapes and the pass's real rows (padded rows are work the
program chose to do, not work the request needs).

``pass_counts(sz, rows, seq)`` -> {group: (flops, bytes)} for the groups
the trace reads (``matmul``, ``flash_attention``) and ``total`` (the
useful flops of the whole pass; its bytes are those of the groups).
Two flops a multiply-add; float32, four bytes a number; each input read
once and each output written once.

The matrix products are those of the program's ``prefill_matmul_flops``
(``chip_smoke.py``): every block's Q, K, V and O projections and its
SwiGLU's three products, and the head on the last position of each
prompt.  Attention's are those of its flash row: QK^T and PV over the
causal (q, k) pairs, S(S+1)/2 a head.
"""
from __future__ import annotations

F32 = 4


def _product(T, n_in, n_out):
    """(flops, bytes) of a (T, n_in) x (n_in, n_out) product."""
    return 2 * T * n_in * n_out, F32 * (T * n_in + n_in * n_out + T * n_out)


def pass_counts(sz, rows: int, seq: int):
    d, ff, V = sz["d_model"], sz["d_ff"], sz["vocab_size"]
    H, KV, hd, L = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"], sz["n_layers"]
    T = rows * seq
    layer = [_product(T, d, H * hd), _product(T, d, KV * hd), _product(T, d, KV * hd),
             _product(T, H * hd, d),
             _product(T, d, ff), _product(T, d, ff), _product(T, ff, d)]
    mm_f = L * sum(f for f, _ in layer)
    mm_b = L * sum(b for _, b in layer)
    hf, hb = _product(rows, d, V)
    mm_f, mm_b = mm_f + hf, mm_b + hb
    pairs = seq * (seq + 1) // 2
    fa_f = L * 4 * hd * pairs * rows * H
    fa_b = L * F32 * (2 * rows * seq * H * hd + 2 * rows * seq * KV * hd)
    return {"matmul": (mm_f, mm_b), "flash_attention": (fa_f, fa_b),
            "total": (mm_f + fa_f, mm_b + fa_b)}


def launches(sz):
    """The port's kernel launches a pass: one flash_attention a layer."""
    return {"flash_attention": sz["n_layers"]}
