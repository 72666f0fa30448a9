"""The port's serving engine against the JAX package's, on the CPU.

Reduced qwen3-4b; the JAX engine's weights go through ``params_from_jax``.
The two engines must answer the same requests with the same batching and
padding, and generate the same tokens wherever the JAX top-2 logit gap
is above 1e-4 of max|logit|.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from tests._torch_parity import REL_TOL, jax_32bit, models  # noqa: F401
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.jax              # the JAX engine is the reference


def test_configs_are_the_same():
    for name in REGISTRY:
        assert REGISTRY[name].__dict__ == JAX_REGISTRY[name].__dict__, name
    jcfg, _, _, cfg, _, _ = models("qwen3-4b")
    assert cfg.__dict__ == jcfg.__dict__
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.qk_norm) == (2, 256, 32, True)
    assert cfg.n_kv_heads < cfg.n_heads


def _jax_greedy_gaps(jmodel, jparams, toks, n, max_len):
    """Per position of the greedy continuation: the JAX top-2 logit gap,
    relative to max|logit|."""
    cache = jmodel.init_cache(toks.shape[0], max_len, dtype=jnp.float32)
    lg, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache)
    gaps = []
    for i in range(n):
        lgn = np.asarray(lg, np.float64).reshape(toks.shape[0], -1)
        top2 = np.sort(lgn, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]) / np.max(np.abs(lgn), -1))
        if i + 1 < n:
            tok = jnp.argmax(lg.reshape(toks.shape[0], -1), -1).astype(jnp.int32)
            lg, cache = jmodel.decode_step(jparams, tok[:, None], cache)
    return np.stack(gaps, axis=1)                  # (B, n)


def test_serving_engine_matches_jax_engine():
    jcfg, jmodel, _, cfg, _, _ = models("qwen3-4b")
    B, S, n_dec = 2, 16, 3
    jeng = JaxServingEngine(jcfg, batch_size=B, prompt_len=S,
                            decode_tokens=n_dec, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = ServingEngine(cfg, batch_size=B, prompt_len=S, decode_tokens=n_dec,
                        params=params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(5)]          # 5 requests: the last batch is padded
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, tokens=p, arrival_s=time.time()))
        eng.submit(Request(rid=i, tokens=p, arrival_s=time.time()))
    jout, out = [], []
    while eng.queue or jeng.queue:
        jout += jeng.pump()
        out += eng.pump()
    assert len(out) == len(jout) == len(prompts)
    assert [c.rid for c in out] == [c.rid for c in jout]
    assert all(c.tokens.shape == (n_dec,) for c in out)
    assert all(c.latency_ms > 0 for c in out) and eng.p99_ms() > 0

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


def test_unported_blocks_name_their_slice():
    for arch in ("whisper-large-v3", "qwen2-vl-7b"):
        with pytest.raises(NotImplementedError, match="encoder/vision slice"):
            build_model(reduced(REGISTRY[arch]), "cpu")
    for arch in ("qwen3-4b", "rwkv6-1.6b", "zamba2-2.7b",    # served since slice 2
                 "yi-6b", "qwen1.5-4b", "minitron-4b",       # the rest of the dense family
                 "mixtral-8x22b", "dbrx-132b"):              # and MoE
        assert build_model(reduced(REGISTRY[arch]), "cpu").cfg.name == arch
        assert build_model(REGISTRY[arch], "cpu").cfg.name == arch
