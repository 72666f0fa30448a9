"""The port's qwen3-4b model against the JAX package's, on the CPU.

Reduced qwen3-4b (2 layers, d_model 256, GQA, qk_norm) and its sliding-
window variant.  The JAX model's weights go through ``params_from_jax``;
prefill and decode logits must agree to 1e-4 of max|logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_parity import REL_TOL, jax_32bit, models, rel_err, torch  # noqa: F401

pytestmark = pytest.mark.jax              # the JAX model is the reference


def test_params_from_jax_is_bit_exact():
    _, _, jparams, cfg, _, params = models("qwen3-4b")
    jnp_tree = jax.tree.map(np.asarray, jparams)
    assert len(params["blocks"]) == cfg.n_layers
    for i, block in enumerate(params["blocks"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jnp_tree["blocks"])[0]:
            t = block
            for key in path:
                t = t[key.key]
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == leaf[i].tobytes(), (i, path)
    for name in ("embed", "final_norm", "head"):
        for key, leaf in jnp_tree[name].items():
            assert params[name][key].numpy().tobytes() == leaf.tobytes()


@pytest.mark.parametrize("arch,S", [
    ("qwen3-4b", 12),
    ("qwen3-4b-swa", 24),      # window 16: a rolling cache, decoded past it
])
def test_prefill_and_decode_logits_match_jax(arch, S):
    jcfg, jmodel, jparams, _, model, params = models(arch)
    rng = np.random.default_rng(0)
    B, steps, max_len = 2, 3, 32
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    jcache = jmodel.init_cache(B, max_len, dtype=jnp.float32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                     jcache)
    cache = model.init_cache(B, max_len, dtype=torch.float32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                  cache)
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
    if jcfg.sliding_window:
        assert cache["layers"][0].rolling
        assert cache["layers"][0].k.shape[2] == jcfg.sliding_window


def test_decode_matches_prefill_over_one_more_token():
    """chip_smoke.py's full-width check at CPU size: decode after a prompt
    equals a prefill over prompt + token (decode vs flash attention)."""
    _, _, _, cfg, model, params = models("qwen3-4b")
    rng = np.random.default_rng(3)
    B, S = 2, 9
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    cache = model.init_cache(B, S + 4, dtype=torch.float32)
    _, cache = model.prefill(params, {"tokens": tokens[:, :S]}, cache)
    lg, _ = model.decode_step(params, tokens[:, S:], cache)
    full, _ = model.prefill(params, {"tokens": tokens},
                            model.init_cache(B, S + 4, dtype=torch.float32))
    assert rel_err(lg[:, 0], full) <= REL_TOL
