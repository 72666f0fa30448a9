"""Operation and byte counts of one layer of each family against values
worked out by hand (the sums are in the comments)."""
import pytest

from harness.cell import family_module

DENSE = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
         "d_ff": 8, "vocab_size": 10}
RWKV = {"n_layers": 1, "d_model": 4, "d_ff": 8, "vocab_size": 10, "rwkv_head_dim": 2,
        "lora_rank": 1, "decay_rank": 2}


def test_dense_layer_by_hand():
    """One prompt of 3 tokens. Products (flops; bytes = 4 x (in + weight +
    out)): q 2*3*4*4 = 96 (4*(12+16+12) = 160), k and v 48 each (4*(12+8+6)
    = 104), o 96 (160), gate and up 192 each (4*(12+32+24) = 272), down
    192 (4*(24+32+12) = 272): 864 and 1344; the head on the last token
    2*4*10 = 80 (4*(4+40+10) = 216).  Flash: 6 causal pairs a head,
    4*2*6*2 = 96 flops, 4*(2*3*2*2 + 2*3*1*2) = 144 bytes."""
    c = family_module("flops", "dense").pass_counts(DENSE, rows=1, seq=3)
    assert c["matmul"] == (864 + 80, 1344 + 216)
    assert c["flash_attention"] == (96, 144)
    assert c["total"] == (944 + 96, 1560 + 144)


def test_rwkv6_layer_by_hand():
    """One prompt of 3 tokens.  r, k, v, g, o: 5 x 96 flops, 5 x 160 bytes;
    channel mix k 192 (272), v 192 (272), r 96 (160); W1 (4 x 5) 2*3*4*5 =
    120 (4*(12+20+15) = 188); W2 (five 1 x 4) 2*5*3*1*4 = 120 (4*(15+20+60)
    = 380); D1 (4 x 2) 48 (4*(12+8+6) = 104), D2 (2 x 4) 48 (4*(6+8+12) =
    104): 1296 and 2280; the head 80 (216).  Scan: 3 steps x 2 heads x
    4*2*2 = 96 flops; 4*(5*3*2*2 + 2*2 + 2*2*2*2) = 320 bytes."""
    c = family_module("flops", "rwkv6").pass_counts(RWKV, rows=1, seq=3)
    assert c["matmul"] == (1296 + 80, 2280 + 216)
    assert c["rwkv6_scan"] == (96, 320)


@pytest.mark.parametrize("family,sz", [("dense", DENSE), ("rwkv6", RWKV)])
def test_counts_grow_with_real_rows(family, sz):
    f = family_module("flops", family)
    one, three = f.pass_counts(sz, 1, 3), f.pass_counts(sz, 3, 3)
    assert three["total"][0] == 3 * one["total"][0]
    assert one["total"][1] < three["total"][1] < 3 * one["total"][1]   # weights read once a pass
