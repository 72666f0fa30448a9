"""The port's qwen2-vl-7b (M-RoPE and the vision stub) against the JAX
package's, on the CPU; and both new engines (qwen2-vl-7b and
whisper-large-v3) against the JAX engines.

Reduced qwen2-vl-7b: 2 layers, d_model 256, 8 query heads of 32 on 1 kv
head, M-RoPE sections (4, 6, 6), 8 patches of 256 features.  The JAX
model's weights go through ``params_from_jax``; prefill and decode logits
must agree to 1e-4 of max|logit| with random-normal patches (the vision
projection and the compressed text positions) and without them (text
positions, mrope_delta 0).  M-RoPE alone must agree to float32 rounding.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import rope as jax_rope
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from tests._torch_parity import REL_TOL, jax_32bit, models, rel_err, torch  # noqa: F401
from tests.test_torch_serving import _jax_greedy_gaps
from repro_torch.models import rope
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.jax              # the JAX model is the reference

ARCH = "qwen2-vl-7b"
F32_TOL = 2e-5                            # the kernels' float32 contract, of max|y|


def extras(cfg, B, rng, patches=True):
    """Random-normal patches (or none) as numpy arrays."""
    if not patches:
        return {}
    return {"patches": rng.standard_normal(
        (B, cfg.vision_patches, cfg.frontend_dim)).astype(np.float32)}


def run_both(arch, tokens, ex, steps=3, max_len=32):
    """Prefill and ``steps`` greedy decode steps in both packages; returns
    the worst logits error relative to max|logit| and the port's cache."""
    jcfg, jmodel, jparams, _, model, params = models(arch)
    B = tokens.shape[0]
    jcache = jmodel.init_cache(B, max_len, dtype=jnp.float32)
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                           **{k: jnp.asarray(v) for k, v in ex.items()}}, jcache)
    cache = model.init_cache(B, max_len, dtype=torch.float32)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                       **{k: torch.from_numpy(v) for k, v in ex.items()}}, cache)
    assert lg.shape == (B, jcfg.vocab_size)
    worst = rel_err(lg, jlg)
    tok = np.array(jnp.argmax(jlg, -1), np.int32)[:, None]
    for _ in range(steps):
        jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
        assert lg.shape == (B, 1, jcfg.vocab_size)
        worst = max(worst, rel_err(lg, jlg))
        tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    if "mrope_delta" in jcache:
        assert cache["mrope_delta"] == int(jcache["mrope_delta"])
    return worst, cache


def test_m_rope_matches_jax():
    rng = np.random.default_rng(0)
    for hd, sections in ((32, (4, 6, 6)), (128, (16, 24, 24))):   # reduced, published
        x = rng.standard_normal((2, 10, 3, hd)).astype(np.float32)
        for Pn in (1, 4, 8):
            thw = np.asarray(jnp.concatenate([
                jax_rope.vision_positions_thw(2, Pn),
                jax_rope.text_positions_thw(jnp.arange(Pn, 10)[None].repeat(2, 0) + 3)], 1))
            got_thw = torch.cat([rope.vision_positions_thw(2, Pn),
                                 rope.text_positions_thw(
                                     torch.arange(Pn, 10, dtype=torch.int32)[None].expand(2, -1) + 3)],
                                1)
            assert got_thw.dtype == torch.int32
            np.testing.assert_array_equal(got_thw.numpy(), thw)
            want = np.asarray(jax_rope.apply_m_rope(jnp.asarray(x), jnp.asarray(thw),
                                                    1_000_000.0, sections))
            got = rope.apply_m_rope(torch.from_numpy(x), got_thw, 1_000_000.0, sections)
            assert rel_err(got, want) <= F32_TOL, (hd, Pn)
        # text positions: M-RoPE is 1-D RoPE
        pos = torch.arange(10)[None].expand(2, -1)
        np.testing.assert_array_equal(
            rope.apply_m_rope(torch.from_numpy(x), rope.text_positions_thw(pos), 1e6, sections),
            rope.apply_rope(torch.from_numpy(x), pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        rope.apply_m_rope(torch.from_numpy(x), got_thw, 1e6, (4, 6, 6))


def test_prefill_and_decode_logits_match_jax():
    """With random-normal patches and without them (each test loops over
    its cases: see tests/_torch_parity.py for why)."""
    cfg = models(ARCH)[3]
    assert (cfg.m_rope_sections, cfg.vision_patches, cfg.frontend_dim) == ((4, 6, 6), 8, 256)
    for patches in (True, False):
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        worst, cache = run_both(ARCH, tokens, extras(cfg, 2, rng, patches))
        assert worst <= REL_TOL, (patches, worst)
        # 8 patches on a grid of side 2: text positions start at 2, not 8
        assert cache["mrope_delta"] == (2 - 8 if patches else 0)
        assert cache["step"] == 12 + 3 and int(cache["layers"][0].pos.max()) == 12 + 3


def test_reset_cache_after_patches_equals_fresh_cache():
    """A text-only pass on a reset cache after a pass with patches equals a
    fresh cache's, bit for bit; without the reset, the stale mrope_delta
    moves the decode step's rotation."""
    _, _, _, cfg, model, params = models(ARCH)
    rng = np.random.default_rng(5)
    B, S = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    ex = {k: torch.from_numpy(v) for k, v in extras(cfg, B, rng).items()}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))

    def text_pass(cache):
        first, cache = model.prefill(params, {"tokens": tokens}, cache)
        lg, _ = model.decode_step(params, tok, cache)
        return first, lg

    fresh = text_pass(model.init_cache(B, 32, dtype=torch.float32))
    used = model.init_cache(B, 32, dtype=torch.float32)
    model.prefill(params, {"tokens": tokens, **ex}, used)
    assert used["mrope_delta"] == -6
    stale = text_pass(used)
    model.prefill(params, {"tokens": tokens, **ex}, used)
    again = text_pass(model.reset_cache(used))
    assert used["mrope_delta"] == 0
    assert all(torch.equal(a, f) for a, f in zip(again, fresh))
    assert torch.equal(stale[0], fresh[0]) and rel_err(stale[1], fresh[1]) > REL_TOL


def test_serving_engine_matches_jax_engine():
    """qwen2-vl-7b's and whisper-large-v3's engines pass zero patches /
    frames to every prefill; same batching, padding and tokens wherever the
    JAX top-2 gap is above 1e-4 of max|logit|."""
    for arch in (ARCH, "whisper-large-v3"):
        check_engine(arch)


def check_engine(arch):
    jcfg, jmodel, _, cfg, _, _ = models(arch)
    B, S, n_dec = 2, 16, 3
    jeng = JaxServingEngine(jcfg, batch_size=B, prompt_len=S, decode_tokens=n_dec, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = ServingEngine(cfg, batch_size=B, prompt_len=S, decode_tokens=n_dec,
                        params=params, device="cpu")
    jex = jeng._dummy_extras()
    assert set(eng.extras) == set(jex) and len(jex) == 1
    for k, v in eng.extras.items():
        assert tuple(v.shape) == jex[k].shape and not v.any()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=S).astype(np.int32) for _ in range(3)]
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, tokens=p, arrival_s=time.time()))
        eng.submit(Request(rid=i, tokens=p, arrival_s=time.time()))
    jout, out = [], []
    while eng.queue or jeng.queue:
        jout += jeng.pump()
        out += eng.pump()
    assert [c.rid for c in out] == [c.rid for c in jout] == [0, 1, 2]
    for start in range(0, len(prompts), B):
        batch = np.zeros((B, S), np.int32)
        for i, p in enumerate(prompts[start:start + B]):
            batch[i] = p
        gaps = _jax_greedy_gaps(jmodel, jeng.params, batch, n_dec, S + n_dec + 8, jex)
        for i in range(len(prompts[start:start + B])):
            c, jc = out[start + i], jout[start + i]
            for t in range(n_dec):
                if gaps[i, t] <= REL_TOL:
                    break                  # a near-tie: later tokens may differ
                assert c.tokens[t] == jc.tokens[t], (arch, c.rid, t)
