"""``flash_attention`` with a V narrower than Q and K: multi-head latent
attention's q.k width 192 beside a V width of 128.

On the CPU the wrapper runs ``kernels/ref.attention_ref``, which takes V's
width as its own: held against the softmax written out.  On a card (marked
``card``; it skips here) ``flash_attn_kernel<float, 192, 128>`` runs
against that plain version at ``tests/test_kernels.py``'s float32
tolerance, 2e-5 of the largest value, on the cell's shape, a ragged
length and the kernel table's, with V a strided view of the latent's
product as the model hands it over; the launches count under
``flash_attention_mla``."""
import math

import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _inputs(B, S, H, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, S, H, 192, generator=g, device=device)
    k = torch.randn(B, S, H, 192, generator=g, device=device)
    kv = torch.randn(B, S, H, 256, generator=g, device=device)
    return q, k, kv[..., 128:]          # V as the model takes it: half of W_kvb's product


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_plain_attention_takes_v_of_its_own_width():
    q, k, v = _inputs(2, 11, 3, "cpu")
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(192)
    s = s.masked_fill(~torch.ones(11, 11, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert out.shape == (2, 11, 3, 128) and _rel(out, want) <= TOL
    assert ops.launch_counts()["flash_attention_mla"] == 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :, :2])


@pytest.mark.card
@pytest.mark.parametrize("B,S,H", [(6, 64, 16), (1, 65, 4), (2, 130, 16), (4, 512, 16)])
def test_kernel_matches_plain_at_k192_v128(card, B, S, H):
    q, k, v = _inputs(B, S, H, card, seed=B + S)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, 128)
    assert _rel(out, ref.attention_ref(q, k, v, causal=True)) <= TOL
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_mla"] == 1
