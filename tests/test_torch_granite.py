"""granite-4.0-h through the port's served path on the CPU, at a small size
with both layer kinds, against the benchmark's plain reference
(``perfbench/reference/granite_hybrid.py``: sequential Mamba2, NoPE GQA at
the attention multiplier's scale, a loop over the held experts, the muP
multipliers): the prefill's logits, decoding through the mixed cache, the
expert shares of an expert-parallel group, the dropless layer and the
cache's reset."""
import pytest
import torch

from tests._torch_granite import reference, reference_logits, rel, sizes, small_model
from repro_torch.kernels.moe_gemm import TILE_ROWS
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe
from repro_torch.models import ssm

TOL = 2e-5          # of max|logit|: float32 over five layers, sums in other orders


@pytest.mark.parametrize("held", [0, 3])
def test_prefill_logits_match_reference(held):
    """All 8 experts held, and a card's share of 3 (experts 0-2): the
    reference is given the same share."""
    model, params = small_model(seed=3, experts_held=held)
    tokens = torch.randint(0, model.cfg.vocab_size, (3, 20), generator=torch.Generator().manual_seed(4))
    want = reference_logits(params, model.cfg, tokens)[:, -1]
    with torch.inference_mode():
        cache = model.init_cache(3, 28, dtype=torch.float32)
        got, _ = model.prefill(params, {"tokens": tokens}, cache)
    assert rel(got, want) <= TOL
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_decode_through_the_mixed_cache_matches_full_forward():
    """Prefill of 13 tokens, then 3 decode steps: each step's logits equal
    the reference's full forward at that position; the cache holds a KV
    cache for each attention layer and conv tail and SSD state for each
    Mamba2 layer."""
    model, params = small_model(seed=5, experts_held=5)
    S0, n = 13, 3
    tokens = torch.randint(0, model.cfg.vocab_size, (2, S0 + n),
                           generator=torch.Generator().manual_seed(6))
    want = reference_logits(params, model.cfg, tokens)
    with torch.inference_mode():
        cache = model.init_cache(2, S0 + n + 4, dtype=torch.float32)
        kinds = [type(c) for c in cache["layers"]]
        assert kinds == [attn_lib.KVCache if k == "attn" else ssm.MambaCache
                         for k in model.cfg.pattern]
        got = [model.prefill(params, {"tokens": tokens[:, :S0]}, cache)[0]]
        for t in range(S0, S0 + n):
            got.append(model.decode_step(params, tokens[:, t:t + 1], cache)[0][:, 0])
    for i, g in enumerate(got):
        assert rel(g, want[:, S0 - 1 + i]) <= 5 * TOL, i


def test_expert_shares_sum_to_the_uncut_layer():
    """Four cards of an expert-parallel group, each holding 2 of 8 experts
    (share s: experts 2s, 2s + 1, its router's columns rotated so they come
    first): their layers' outputs, with the shared expert every card adds
    counted once, sum to the uncut reference layer."""
    model, params = small_model(seed=7)
    cfg = model.cfg
    p = params["blocks"][0]["moe"]
    x = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(8))
    E, held = cfg.n_experts, 2
    share_cfg = cfg.replace(experts_held=held)
    total = torch.zeros_like(x)
    with torch.inference_mode():
        for s in range(4):
            cols = torch.roll(torch.arange(E), -held * s)
            ps = {"router": p["router"][:, cols], "shared": p["shared"],
                  **{k: p[k][held * s:held * (s + 1)] for k in ("w_gate", "w_up", "w_down")}}
            total += moe.apply_moe_dropless(ps, x, share_cfg)
        sh = p["shared"]
        shared = reference._swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                                   reference.Precision("float32"))
        whole = reference._moe(p, x, sizes(cfg), reference.Precision("float32"))
    assert rel(total - 3 * shared, whole) <= TOL


def test_dropless_layer_and_the_caches_reset():
    """Every token routed to the same three experts (all held): each expert
    takes every token, and every assignment is computed; the layer equals
    the plain loop over experts.  Then reset_cache zeroes each Mamba2
    layer's conv tail and state and leaves each KV cache as it was."""
    model, params = small_model(seed=9, experts_held=3)
    cfg = model.cfg
    p = dict(params["blocks"][0]["moe"])
    router = torch.zeros_like(p["router"])
    router[:, 1] = 1.0                        # expert 1 first, then the ties 0 and 2
    p["router"] = router
    x = torch.rand(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(10)) + 0.1
    moe.reset_held_counts()
    with torch.inference_mode():
        y = moe.apply_moe_dropless(p, x, cfg, layer=0)
        want = moe.moe_dropless_plain(p, x, cfg)
    T = x.shape[0] * x.shape[1]
    assert moe.held_counts() == {0: {"assignments": T * cfg.top_k, "max_rows": T,
                                     "dropped": 0, "tiles": 3 * -(-T // TILE_ROWS),
                                     "experts": 3, "calls": 1}}
    assert rel(y, want) <= TOL

    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(11))
    with torch.inference_mode():
        cache = model.init_cache(2, 16, dtype=torch.float32)
        model.prefill(params, {"tokens": tokens}, cache)
        kv = [(c.k.clone(), c.v.clone(), c.pos.clone()) for c in cache["layers"]
              if isinstance(c, attn_lib.KVCache)]
        mamba = [c for c in cache["layers"] if isinstance(c, ssm.MambaCache)]
        assert all(c.ssm.abs().sum() > 0 and c.conv.abs().sum() > 0 for c in mamba)
        model.reset_cache(cache)
    assert all(not c.ssm.any() and not c.conv.any() for c in mamba)
    kept = [(c.k, c.v, c.pos) for c in cache["layers"] if isinstance(c, attn_lib.KVCache)]
    assert len(kept) == 2 and all(torch.equal(a, b) for old, new in zip(kv, kept)
                                  for a, b in zip(old, new))
    assert cache["step"] == 0
