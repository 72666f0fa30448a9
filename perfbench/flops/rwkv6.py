"""Operations and bytes of one prefill pass of RWKV6, from the
configuration's shapes and the pass's real rows.

``pass_counts(sz, rows, seq)`` -> {group: (flops, bytes)} for the groups
the trace reads (``matmul``, ``rwkv6_scan``) and ``total``.  Two flops a
multiply-add; float32, four bytes a number; each input read once and each
output written once.

The matrix products are those of the program's ``prefill_matmul_flops``
(``chip_smoke.py``): r, k, v, g and o (five d x d), the channel mix's k,
v (d x d_ff, d_ff x d) and r (d x d), the low-rank mixes (d x 5R and the
five R x d of W2) and the decay's (d x R_d, R_d x d), and the head on the
last position.  The scan's are those of its row in ``chip_smoke.py``: a
step's state read-out r S and rank-1 update k^T v, 4 hd^2 a head and
step; its bytes r, k, v, log w in and y out, u, and the state in and out.
"""
from __future__ import annotations

F32 = 4


def _product(T, n_in, n_out):
    return 2 * T * n_in * n_out, F32 * (T * n_in + n_in * n_out + T * n_out)


def pass_counts(sz, rows: int, seq: int):
    d, ff, V, L = sz["d_model"], sz["d_ff"], sz["vocab_size"], sz["n_layers"]
    hd, R, Rd = sz["rwkv_head_dim"], sz["lora_rank"], sz["decay_rank"]
    H = d // hd
    T = rows * seq
    layer = [_product(T, d, d)] * 5 + [
        _product(T, d, ff), _product(T, ff, d), _product(T, d, d),
        _product(T, d, 5 * R),
        (2 * 5 * T * R * d, F32 * (5 * T * R + 5 * R * d + 5 * T * d)),   # W2: five R x d
        _product(T, d, Rd), _product(T, Rd, d)]
    mm_f = L * sum(f for f, _ in layer)
    mm_b = L * sum(b for _, b in layer)
    hf, hb = _product(rows, d, V)
    mm_f, mm_b = mm_f + hf, mm_b + hb
    sc_f = L * rows * seq * H * 4 * hd * hd
    sc_b = L * F32 * (5 * rows * seq * H * hd + H * hd + 2 * rows * H * hd * hd)
    return {"matmul": (mm_f, mm_b), "rwkv6_scan": (sc_f, sc_b),
            "total": (mm_f + sc_f, mm_b + sc_b)}


def launches(sz):
    """The port's kernel launches a pass: one rwkv6_scan a layer."""
    return {"rwkv6_scan": sz["n_layers"]}
