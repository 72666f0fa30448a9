"""``Model.prefill``'s graph dispatch (``models/graphs.py``) on the CPU.

A CPU call is never captured.  With ``graphs.Graph`` replaced by
``FakeGraph`` (a capture that launches nothing, a replay that runs the
captured pass), the dispatch runs here: which calls are eligible, what a
key is, the static inputs a replay reads, the host fields it sets and the
clone it returns, against ``transformer.prefill`` run eagerly.  The MoE
layers' counts accumulate in place, so a graph adds to what ``held_counts``
and ``drop_counts`` read.  The card's own graphs are held to the eager pass
in ``tests/test_torch_prefill_graph_card.py``.

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import pytest
import torch

from _torch_granite import small_model
from repro_torch.configs import REGISTRY, reduced
from repro_torch.kernels.moe_gemm import TILE_ROWS
from repro_torch.models import graphs, moe
from repro_torch.models import transformer as T
from repro_torch.models.zoo import build_model
from repro_torch.profiling import spans
from repro_torch.tree import tree_leaves, tree_map

B = 2


class FakeGraph:
    """``graphs.Graph`` on the CPU: a capture takes the pass and runs nothing
    (a capture launches nothing); a replay runs it and writes its logits
    into the captured output."""
    device_type = "cpu"

    def __init__(self, device, stream=None):
        self.stream = stream or object()

    def warm(self, fn):
        self.out = fn()
        return self.out

    def capture(self, fn):
        self.fn, self.static = fn, self.out[0].clone()
        return self.static, self.out[1]

    def replay(self):
        self.static.copy_(self.fn()[0])


class RefusedGraph(FakeGraph):
    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


def served(arch, seed=0):
    cfg = reduced(REGISTRY[arch]).replace(n_layers=2)
    model = build_model(cfg, "cpu")
    return cfg, model, model.init(seed)


def batch_of(cfg, S, seed):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn((B, min(cfg.vision_patches, S), cfg.frontend_dim),
                                       generator=g)
    return batch


def eager(cfg, params, batch, cache):
    """transformer.prefill on a copy of ``cache`` -> (logits, that copy)."""
    copy = {k: tree_map(torch.clone, v) if isinstance(v, list) else v for k, v in cache.items()}
    return T.prefill(params, cfg, batch, copy)


@pytest.mark.parametrize("why", ["cpu", "grad", "hints"])
def test_ineligible_calls_run_eagerly(why, monkeypatch):
    """Off the card, under autograd or with sharding hints a call runs
    transformer.prefill as it is and counts ``eager``; the same call in
    inference mode on a capturable device is captured."""
    cfg, model, params = served("qwen1.5-4b")
    batch = batch_of(cfg, 8, 1)
    if why != "cpu":
        monkeypatch.setattr(graphs, "Graph", FakeGraph)
    shard = T.ShardingHints() if why == "hints" else T.NO_HINTS
    cache = model.init_cache(B, 12, dtype=torch.float32)
    want, _ = eager(cfg, params, batch, cache)
    spans.reset_graph_counts()
    with torch.enable_grad() if why == "grad" else torch.inference_mode():
        for _ in range(2):
            got, cache = model.prefill(params, batch, cache, shard=shard)
            assert torch.equal(got, want) and cache["step"] == 8
    assert spans.graph_counts() == {"captured": 0, "replayed": 0, "eager": 2}
    assert not model.graphs._entries
    with torch.inference_mode():
        model.prefill(params, batch, cache)
    assert spans.graph_counts()["captured"] == (0 if why == "cpu" else 1)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-7b", "rwkv6-1.6b"])
def test_a_new_shape_cache_or_tree_is_a_new_key_never_a_stale_replay(arch, monkeypatch):
    """Each call equals transformer.prefill on the same inputs and cache
    state, logits, cache and host fields: a new shape, cache or parameter
    tree captures anew, a known key replays from its static inputs, a
    result handed out is never overwritten, and past ``MAX_GRAPHS`` keys
    the least recently used is dropped and captured again."""
    monkeypatch.setattr(graphs, "Graph", FakeGraph)
    cfg, model, params = served(arch)
    params2 = model.init(1)
    caches = [model.init_cache(B, 20, dtype=torch.float32) for _ in range(2)]
    spans.reset_graph_counts()
    handed = []
    # (params, prompt length, cache, reset first, outcome)
    calls = [(params, 8, 0, True, "captured"), (params, 8, 0, True, "replayed"),
             (params, 8, 0, False, "replayed"), (params, 12, 0, True, "captured"),
             (params, 8, 1, True, "captured"), (params2, 8, 0, True, "captured"),
             (params, 8, 0, True, "replayed"), (params, 16, 0, True, "captured"),
             (params, 12, 0, True, "captured")]
    with torch.inference_mode():
        for i, (p, S, c, reset, outcome) in enumerate(calls):
            cache = caches[c]
            if reset:
                model.reset_cache(cache)
            batch = batch_of(cfg, S, seed=10 + i)
            want, want_cache = eager(cfg, p, batch, cache)
            before = spans.graph_counts()[outcome]
            got, cache = model.prefill(p, batch, cache)
            assert spans.graph_counts()[outcome] == before + 1, (i, spans.graph_counts())
            assert torch.equal(got, want), i
            for a, b in zip(tree_leaves(cache["layers"]), tree_leaves(want_cache["layers"])):
                assert torch.equal(a, b), i
            assert {k: cache.get(k) for k in ("step", "mrope_delta")} == \
                {k: want_cache.get(k) for k in ("step", "mrope_delta")}, i
            handed.append((got, got.clone()))
    assert all(torch.equal(a, b) for a, b in handed)
    assert len(model.graphs._entries) == graphs.MAX_GRAPHS


def test_moe_counts_accumulate_in_place():
    """held_counts over several apply_moe_dropless calls reads a sum, a max
    and a sum, as counted call by call; drop_counts sums as apply_moe's
    calls drop.  A reset zeroes each layer's tensor in place (a graph keeps
    adding to it) and reads empty; the counts take calls outside inference
    mode after calls inside it."""
    model, params = small_model(seed=9, experts_held=3)
    cfg = model.cfg
    p = params["blocks"][0]["moe"]
    xs = [torch.rand(2, n, cfg.d_model, generator=torch.Generator().manual_seed(n)) - 0.5
          for n in (9, 5, 13)]
    want = {"assignments": 0, "max_rows": 0, "dropped": 0, "tiles": 0, "experts": 0, "calls": 0}
    for x in xs:
        T_ = x.shape[0] * x.shape[1]
        _, _, offsets, _ = moe.route_sorted(p["router"], x.reshape(T_, -1), cfg.top_k, cfg.n_held)
        rows = (offsets[1:] - offsets[:-1]).tolist()
        want = {"assignments": want["assignments"] + int(offsets[-1]),
                "max_rows": max(want["max_rows"], *rows),
                "dropped": want["dropped"] + sum(max(r - T_, 0) for r in rows),
                "tiles": want["tiles"] + sum(-(-r // TILE_ROWS) for r in rows),
                "experts": want["experts"] + sum(r > 0 for r in rows),
                "calls": want["calls"] + 1}
    moe.reset_held_counts()
    with torch.inference_mode():
        for x in xs[:2]:
            moe.apply_moe_dropless(p, x, cfg, layer=4)
    with torch.no_grad():
        moe.apply_moe_dropless(p, xs[2], cfg, layer=4)
    assert moe.held_counts() == {4: want}
    counts = moe._held[4].dev
    moe.reset_held_counts()
    assert moe.held_counts() == {} and moe._held[4].dev is counts and not counts.any()

    dcfg = reduced(REGISTRY["dbrx-132b"]).replace(capacity_factor=0.5)
    dp = moe.init_moe(torch.Generator().manual_seed(0), dcfg, "cpu")
    x = torch.randn(2, 16, dcfg.d_model, generator=torch.Generator().manual_seed(1))
    moe.reset_drop_counts()
    with torch.inference_mode():
        moe.apply_moe(dp, x, dcfg, layer=2)
    one = moe.drop_counts()[2]
    assert one[0] > 0
    with torch.no_grad():
        moe.apply_moe(dp, x, dcfg, layer=2)
    assert moe.drop_counts() == {2: (2 * one[0], 2 * one[1])}
    moe.reset_drop_counts()
    assert moe.drop_counts() == {}


def test_a_refused_capture_leaves_the_key_eager(monkeypatch):
    """A capture that raises warns, counts ``eager``, returns the eager
    pass's result, and runs the key eagerly from then on."""
    monkeypatch.setattr(graphs, "Graph", RefusedGraph)
    cfg, model, params = served("rwkv6-1.6b")
    cache = model.init_cache(B, 12, dtype=torch.float32)
    spans.reset_graph_counts()
    with torch.inference_mode(), pytest.warns(RuntimeWarning, match="not captured") as seen:
        for seed in (1, 2):
            model.reset_cache(cache)
            batch = batch_of(cfg, 8, seed)
            want, _ = eager(cfg, params, batch, cache)
            got, cache = model.prefill(params, batch, cache)
            assert torch.equal(got, want)
    assert len(seen) == 1
    assert spans.graph_counts() == {"captured": 0, "replayed": 0, "eager": 2}
    (entry,) = model.graphs._entries.values()
    assert entry.graph is None
