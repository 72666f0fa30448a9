"""DeepSeek-V2 through the port on the CPU at a small size (``_torch_mla``):
multi-head latent attention with YaRN, a leading dense layer and the
dropless MoE with un-renormalised gates, against the benchmark's plain
reference (expanded MLA, the experts in a loop).  The prefill's logits,
then three decode steps through the latent cache against the reference's
full forward at each position; the absorbed decode against the expanded
form over the same cache; and the router with ``norm_topk`` true (granite's)
unchanged.  Tolerance 2e-5 of the largest logit: float32 sums in other
orders.

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import math

import pytest
import torch

from _torch_mla import reference_logits, rel, small_model
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import attention, moe, transformer

TOL = 2e-5


@pytest.mark.parametrize("seed", [0, 3])
def test_prefill_logits_match_the_reference(seed):
    model, params = small_model(seed)
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (3, 40), generator=g)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      model.init_cache(3, 48, dtype=torch.float32))
    want = reference_logits(params, model.cfg, tokens)[:, -1]
    assert rel(logits, want) <= TOL
    assert isinstance(cache["layers"][0], attention.LatentCache)
    assert [("ffn" in b, "moe" in b) for b in params["blocks"]] == [(True, False), (False, True),
                                                                   (False, True)]


def test_prefill_then_decode_through_the_latent_cache():
    """Prefill 20 tokens, then decode 3: each step's logits equal the
    reference's full forward at that position; the cache holds c and the
    rotated k_pe of every written position, zeros past them."""
    model, params = small_model(1)
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 23), generator=g)
    want = reference_logits(params, cfg, tokens)
    with torch.inference_mode():
        cache = model.init_cache(2, 32, dtype=torch.float32)
        logits, cache = model.prefill(params, {"tokens": tokens[:, :20]}, cache)
        steps = [logits]
        for t in range(20, 23):
            lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
            steps.append(lg[:, 0])
    for i, lg in enumerate(steps):
        assert rel(lg, want[:, 19 + i]) <= TOL, i
    lc = cache["layers"][1]
    assert lc.pos.tolist() == [23, 23] and cache["step"] == 23
    assert lc.c[:, 23:].abs().max() == 0 and lc.c[:, :23].abs().min(-1).values.min() > 0


def test_absorbed_decode_equals_the_expanded_form():
    """``mla_decode``'s absorbed attention (q_nope through W_kvb's K half
    against c, P c through its V half) against K and V expanded from the
    same latent cache per head, and the plain attention over them
    (``kernels/ref.attention_ref``'s arithmetic, V narrower than K)."""
    model, params = small_model(2)
    cfg = model.cfg
    p = params["blocks"][1]["attn"]
    g = torch.Generator().manual_seed(2)
    B, S, H, n, r, R, V = 2, 9, cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.kv_lora_rank, cfg.v_head_dim
    cache = attention.init_latent_cache(B, 16, cfg, dtype=torch.float32)
    cache.c[:, :S] = torch.randn(B, S, R, generator=g)
    cache.k_pe[:, :S] = torch.randn(B, S, r, generator=g)
    cache.pos.fill_(S)
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    with torch.inference_mode():
        out, cache = attention.mla_decode(p, x, cfg, cache)
        # expanded: every head's K and V from the cache, q as mla_decode builds it
        q_nope, q_pe, _, _ = attention._mla_project(
            p, x, cfg, attention._position_table(cfg, torch.full((B, 1), S, dtype=torch.int32)))
        kv = (cache.c[:, :S + 1] @ p["wkv_b"]).view(B, S + 1, H, n + V)
        k = torch.cat([kv[..., :n], cache.k_pe[:, :S + 1, None].expand(B, S + 1, H, r)], -1)
        q = torch.cat([q_nope, q_pe], -1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * attention.mla_softmax_scale(cfg)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), kv[..., n:])
        want = o.reshape(B, 1, H * V) @ p["wo"]
    assert rel(out, want) <= TOL
    assert attention.mla_softmax_scale(cfg) == pytest.approx(
        (0.1 * 0.707 * math.log(40) + 1) ** 2 / math.sqrt(48))
    assert NEG_INF < 0
    # the YaRN table is unscaled: a configuration without mscale_all_dim
    # (whose table HF scales by m(f, 1)) is refused
    with pytest.raises(NotImplementedError, match="mscale_all_dim"):
        transformer.check_supported(cfg.replace(yarn_mscale_all_dim=0.0))


def test_router_gates_renormalised_or_scaled():
    """``norm_topk`` true (granite): the top-k probabilities over their sum,
    as before; false (DeepSeek-V2): the probabilities as they are; the
    chosen experts and ``route_sorted``'s order the same either way."""
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(40, 32, generator=g), torch.randn(32, 8, generator=g)
    probs = torch.softmax(x @ w, -1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids_n, gates_n, _ = moe._route(w, x, 3)
    assert torch.equal(ids_n, ids[:, :3])
    assert torch.equal(gates_n, top[:, :3] / torch.clamp(top[:, :3].sum(-1, keepdim=True),
                                                         min=1e-9))
    ids_s, gates_s, _ = moe._route(w, x, 3, norm=False)
    assert torch.equal(ids_s, ids_n) and torch.equal(gates_s, top[:, :3])
    a = moe.route_sorted(w, x, 3, 5)
    b = moe.route_sorted(w, x, 3, 5, norm=False)
    for t, u in zip(a[:1] + a[2:], b[:1] + b[2:]):
        assert torch.equal(t, u)
