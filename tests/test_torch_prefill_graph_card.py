"""``Model.prefill``'s CUDA graphs on the card (marked ``card``; they skip
without one), at reduced widths of the three served families: qwen1.5-4b
(flash attention, RoPE), rwkv6-1.6b (the scan, a recurrent state) and
granite-4.0-h (Mamba2 and attention layers, the dropless MoE).

A replayed pass equals ``transformer.prefill`` run eagerly, bit for bit,
in its logits, tokens and cache, and moves the host counts
(``ops.launch_counts()``, ``gemm.declined``, ``rope.position_table.built``)
and the MoE layers' counts by what an eager pass moves them.  The product
kernel's split-K scratch never grows inside a capture, and a capture that
the pass refuses (a host copy that synchronises) leaves the key eager with
the eager pass's outputs.

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import pytest
import torch

from _torch_granite import small_model
from repro_torch.configs import REGISTRY, reduced
from repro_torch.kernels import gemm, ops
from repro_torch.models import moe, rope
from repro_torch.models import transformer as T
from repro_torch.models.zoo import build_model
from repro_torch.profiling import spans
from repro_torch.tree import tree_leaves, tree_map

B, S = 2, 64          # 128 tokens: the served products take the 3xTF32 kernel


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def served(arch, dev):
    if arch == "granite-4.0-h-small":
        model, params = small_model(seed=2, experts_held=5)
        cfg = model.cfg
    else:
        cfg = reduced(REGISTRY[arch]).replace(n_layers=2)
        params = build_model(cfg, "cpu").init(2)
    return cfg, build_model(cfg, dev), tree_map(lambda t: t.to(dev), params)


def tokens(cfg, seed, dev, S=S):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(3, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32,
                                    device=dev)}


def host_counts():
    held = moe.held_counts()
    return {**ops.launch_counts(), "declined": gemm.gemm.declined,
            "tables": rope.position_table.built,
            "held": {k: (c["assignments"], c["calls"]) for k, c in held.items()}}


def moved(a, b):
    out = {k: b[k] - a[k] for k in a if k != "held"}
    out["held"] = {k: (n - a["held"].get(k, (0, 0))[0], c - a["held"].get(k, (0, 0))[1])
                   for k, (n, c) in b["held"].items()}
    return out


@pytest.mark.card
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-1.6b", "granite-4.0-h-small"])
def test_a_replay_equals_the_eager_pass_and_counts_as_it(arch, card):
    """A served loop (reset, prefill, argmax) on one cache: the first call
    captures, the next replay.  Each replay's logits, tokens and cache
    equal transformer.prefill's on a second cache, bit for bit; the host
    counts and the MoE counts move by an eager pass's amounts."""
    cfg, model, params = served(arch, card)
    cache = model.init_cache(B, S + 4, dtype=torch.float32)
    ref_cache = model.init_cache(B, S + 4, dtype=torch.float32)
    spans.reset_graph_counts()
    with torch.inference_mode():
        model.prefill(params, tokens(cfg, 0, card), model.reset_cache(cache))
        assert spans.graph_counts() == {"captured": 1, "replayed": 0, "eager": 0}
        for seed in (1, 2):
            batch = tokens(cfg, seed, card)
            moe.reset_held_counts()
            c0 = host_counts()
            want, _ = T.prefill(params, cfg, batch, T.reset_cache(ref_cache))
            c1 = host_counts()
            got, _ = model.prefill(params, batch, model.reset_cache(cache))
            c2 = host_counts()
            assert torch.equal(got, want), seed
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            for a, b in zip(tree_leaves(cache["layers"]), tree_leaves(ref_cache["layers"])):
                assert torch.equal(a, b), seed
            assert cache["step"] == ref_cache["step"] == S
            eager_moved, replay_moved = moved(c0, c1), moved(c1, c2)
            assert eager_moved == replay_moved, (eager_moved, replay_moved)
            assert eager_moved["gemm"] > 0
            assert (eager_moved["tables"] == 1) == (cfg.rope_theta > 0 and bool(cfg.attn_layers))
            assert bool(eager_moved["held"]) == cfg.moe_dropless
    assert spans.graph_counts() == {"captured": 1, "replayed": 2, "eager": 0}


@pytest.mark.card
def test_the_product_scratch_never_grows_inside_a_capture(card, monkeypatch):
    """Two keys of one model, the second with twice the tokens: no product
    call, plan or scratch is made while a stream captures (the eager first
    run made them), and the first key's replays stay equal to the eager
    pass after the second key's capture."""
    cfg, model, params = served("qwen1.5-4b", card)
    made, make = [], gemm._make_call

    def spy(device, key):
        made.append((key, torch.cuda.is_current_stream_capturing()))
        return make(device, key)

    monkeypatch.setattr(gemm, "_make_call", spy)
    caches = [model.init_cache(B, 2 * S + 4, dtype=torch.float32) for _ in range(2)]
    spans.reset_graph_counts()
    with torch.inference_mode():
        for i, n in enumerate((S, 2 * S)):
            model.prefill(params, tokens(cfg, i, card, n), model.reset_cache(caches[i]))
        batch = tokens(cfg, 5, card)
        got, _ = model.prefill(params, batch, model.reset_cache(caches[0]))
        want, _ = T.prefill(params, cfg, batch, model.init_cache(B, 2 * S + 4, dtype=torch.float32))
    assert made and not any(capturing for _, capturing in made), made
    assert torch.equal(got, want)
    assert spans.graph_counts() == {"captured": 2, "replayed": 1, "eager": 0}


@pytest.mark.card
def test_a_capture_that_raises_leaves_the_key_eager(card, monkeypatch):
    """RoPE's frequencies from a host tensor (a copy that synchronises): the
    capture fails, the call returns the eager pass's logits, a warning
    says so, and later calls of that key run eagerly and equal
    transformer.prefill."""
    cfg, model, params = served("qwen1.5-4b", card)

    def per_call_freqs(head_dim, theta, device=None):
        dim = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
        return torch.tensor(theta, dtype=torch.float32, device=device) ** (-2.0 * dim / head_dim)

    monkeypatch.setattr(rope, "rope_freqs", per_call_freqs)
    cache = model.init_cache(B, S + 4, dtype=torch.float32)
    spans.reset_graph_counts()
    with torch.inference_mode(), pytest.warns(RuntimeWarning, match="not captured"):
        for seed in (1, 2):
            batch = tokens(cfg, seed, card)
            want, _ = T.prefill(params, cfg, batch, model.init_cache(B, S + 4,
                                                                    dtype=torch.float32))
            got, _ = model.prefill(params, batch, model.reset_cache(cache))
            assert torch.equal(got, want), seed
    assert spans.graph_counts() == {"captured": 0, "replayed": 0, "eager": 2}
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
