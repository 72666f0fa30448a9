"""The port's rwkv6-1.6b model and engine against the JAX package's, on
the CPU.

Reduced rwkv6-1.6b (2 layers, d_model 256, 8 heads of 32).  The JAX
model's weights go through ``params_from_jax``; prefill and decode logits
must agree to 1e-4 of max|logit|, and the two engines must generate the
same tokens wherever the JAX top-2 logit gap is above that.  The checks
are shared with ``tests/test_torch_zamba.py``.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import reduced as jax_reduced
from repro.models.zoo import build_model as jax_build_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from tests._torch_parity import REL_TOL, jax_32bit, rel_err, torch  # noqa: F401
from tests.test_torch_serving import _jax_greedy_gaps
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.jax              # the JAX model is the reference

ARCH, LAYERS = "rwkv6-1.6b", 2


@functools.lru_cache(maxsize=None)
def models(arch, layers):
    """Reduced ``arch`` at ``layers`` in both packages, sharing the JAX
    model's weights: (jax cfg, jax model, jax params, cfg, model, params)."""
    with jax.enable_x64(False):
        jcfg = jax_reduced(JAX_REGISTRY[arch], layers=layers)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(7))
    cfg = reduced(REGISTRY[arch], layers=layers)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, "cpu"), params


def check_params_bit_exact(arch, layers):
    _, _, jparams, cfg, _, params = models(arch, layers)
    assert cfg.__dict__ == models(arch, layers)[0].__dict__
    assert len(params["blocks"]) == cfg.n_layers
    leaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    for path, leaf in leaves:
        keys = [k.key for k in path]
        copies = ([(params["blocks"][i], leaf[i]) for i in range(cfg.n_layers)]
                  if keys[0] == "blocks" else [(params[keys[0]], leaf)])
        for t, want in copies:
            for key in keys[1:]:
                t = t[key]
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == want.tobytes(), keys
    return leaves


def check_logits_match_jax(arch, layers, S=12, steps=3):
    jcfg, jmodel, jparams, _, model, params = models(arch, layers)
    rng = np.random.default_rng(0)
    B, max_len = 2, 32
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jmodel.init_cache(B, max_len, dtype=jnp.float32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = model.init_cache(B, max_len, dtype=torch.float32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache)
    assert logits.shape == (B, jcfg.vocab_size)
    assert rel_err(logits, jlogits) <= REL_TOL
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for _ in range(steps):
        jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
        assert lg.shape == (B, 1, jcfg.vocab_size)
        assert rel_err(lg, jlg) <= REL_TOL
        tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    assert cache["step"] == S + steps
    return cache


def check_decode_matches_prefill(arch, layers, S=9):
    """chip_smoke.py's full-width check at CPU size: decode after a prompt
    equals a prefill over prompt + token from a fresh cache; and a reused
    cache, reset, gives the fresh cache's logits."""
    _, _, _, cfg, model, params = models(arch, layers)
    rng = np.random.default_rng(3)
    B = 2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    cache = model.init_cache(B, S + 4, dtype=torch.float32)
    first, cache = model.prefill(params, {"tokens": tokens[:, :S]}, cache)
    lg, cache = model.decode_step(params, tokens[:, S:], cache)
    full, _ = model.prefill(params, {"tokens": tokens},
                            model.init_cache(B, S + 4, dtype=torch.float32))
    assert rel_err(lg[:, 0], full) <= REL_TOL
    stale, _ = model.prefill(params, {"tokens": tokens[:, :S]}, cache)
    again, _ = model.prefill(params, {"tokens": tokens[:, :S]}, model.reset_cache(cache))
    assert torch.equal(again, first)
    return rel_err(stale, first)


def check_engine_matches_jax(arch, layers):
    """5 requests at batch 2: three passes, the last one padded, so a state
    left over from an earlier pass would show."""
    jcfg, jmodel, _, cfg, _, _ = models(arch, layers)
    B, S, n_dec = 2, 16, 3
    jeng = JaxServingEngine(jcfg, batch_size=B, prompt_len=S, decode_tokens=n_dec, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = ServingEngine(cfg, batch_size=B, prompt_len=S, decode_tokens=n_dec,
                        params=params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=S).astype(np.int32) for _ in range(5)]
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, tokens=p, arrival_s=time.time()))
        eng.submit(Request(rid=i, tokens=p, arrival_s=time.time()))
    jout, out, passes = [], [], 0
    while eng.queue or jeng.queue:
        jout += jeng.pump()
        out += eng.pump()
        passes += 1
    assert passes == 3 and len(out) == len(jout) == len(prompts)
    assert [c.rid for c in out] == [c.rid for c in jout]
    assert all(c.tokens.shape == (n_dec,) for c in out)
    compared = 0
    for start in range(0, len(prompts), B):
        batch = np.zeros((B, S), np.int32)
        for i, p in enumerate(prompts[start:start + B]):
            batch[i] = p
        gaps = _jax_greedy_gaps(jmodel, jeng.params, batch, n_dec, S + n_dec + 8)
        for i in range(len(prompts[start:start + B])):
            c, jc = out[start + i], jout[start + i]
            for t in range(n_dec):
                if gaps[i, t] <= REL_TOL:
                    break                  # a near-tie: later tokens may differ
                assert c.tokens[t] == jc.tokens[t], (c.rid, t)
                compared += 1
    assert compared > 0
    return out


def test_params_from_jax_is_bit_exact():
    leaves = check_params_bit_exact(ARCH, LAYERS)
    names = {"/".join(str(k.key) for k in path) for path, _ in leaves}
    assert {"blocks/ln1/bias", "blocks/rwkv/u", "blocks/rwkv/tm_w2"} <= names


def test_prefill_and_decode_logits_match_jax():
    cache = check_logits_match_jax(ARCH, LAYERS)
    assert float(cache["layers"][0].state.abs().max()) > 0


def test_decode_matches_prefill_over_one_more_token():
    assert check_decode_matches_prefill(ARCH, LAYERS) > REL_TOL   # a stale state shows


def test_serving_engine_matches_jax_engine():
    check_engine_matches_jax(ARCH, LAYERS)
