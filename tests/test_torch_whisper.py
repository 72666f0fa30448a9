"""The port's whisper-large-v3 (encoder, cross-attention, LayerNorm with a
bias, sinusoidal positions) against the JAX package's, on the CPU.

Reduced whisper-large-v3: 2 decoder and 2 encoder layers, d_model 256, 8
heads of 32 (MHA), 32 encoder frames.  The JAX model's weights go through
``params_from_jax``; the encoder's output and the prefill and decode
logits must agree to 1e-4 of max|y|, with random-normal frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from tests._torch_parity import REL_TOL, jax_32bit, models, rel_err, torch  # noqa: F401
from tests.test_torch_vlm import run_both
from repro_torch.configs import REGISTRY
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

pytestmark = pytest.mark.jax              # the JAX model is the reference

ARCH = "whisper-large-v3"


def frames(cfg, B, rng):
    return rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def test_sinusoidal_positions_match_jax():
    """The table and the decode step's row agree to float32 rounding of the
    angle: XLA's and torch's exp differ by an ulp in about a tenth of the
    frequencies, which moves sin and cos by up to 2 eps x the angle."""
    eps = np.finfo(np.float32).eps
    for n, d, offset in ((32, 256, 0), (1500, 1280, 0), (16, 1280, 512)):
        want = np.asarray(jax_layers.sinusoidal_positions(n, d, offset))
        got = L.sinusoidal_positions(n, d, offset).numpy()
        assert got.shape == want.shape == (n, d) and got.dtype == np.float32
        pos = np.arange(n, dtype=np.float64)[:, None] + offset
        assert (np.abs(got - want) <= 2 * eps * (1 + pos) + 1e-6).all(), (n, d, offset)
    # the divisor is d // 2 - 1: the last frequency is exactly 1 / 10000
    np.testing.assert_allclose(L.sinusoidal_positions(2, 8)[1, 3].item(), np.sin(1e-4), rtol=1e-6)
    for cfg in (models(ARCH)[3], REGISTRY[ARCH]):
        for step in (0, 12, 515, 1499):
            # the JAX decode step's lines (transformer.py, decode_step)
            dim = jnp.arange(cfg.d_model // 2, dtype=jnp.float32)
            inv = jnp.exp(-jnp.log(10_000.0) * dim / max(cfg.d_model // 2 - 1, 1))
            ang = jnp.asarray(step, jnp.int32).astype(jnp.float32) * inv
            want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)]))
            got = L.sinusoidal_positions(1, cfg.d_model, step)[0].numpy()  # decode_step's row
            assert (np.abs(got - want) <= 2 * eps * (1 + step) + 1e-6).all(), (cfg.d_model, step)


def test_encoder_matches_jax():
    jcfg, _, jparams, cfg, _, params = models(ARCH)
    x = frames(cfg, 2, np.random.default_rng(1))
    want = jax_transformer._encoder_forward(jparams, jcfg, jnp.asarray(x),
                                            jax_transformer.ShardingHints(), False)
    got = T._encoder_forward(params, cfg, torch.from_numpy(x))
    assert got.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    assert rel_err(got, want) <= REL_TOL


def test_prefill_and_decode_logits_match_jax():
    cfg = models(ARCH)[3]
    assert (cfg.encoder_layers, cfg.encoder_seq_len, cfg.n_heads, cfg.n_kv_heads) == (2, 32, 4, 4)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    worst, cache = run_both(ARCH, tokens, {"frames": frames(cfg, 2, rng)})
    assert worst <= REL_TOL, worst
    assert cache["step"] == 12 + 3 and len(cache["cross"]) == cfg.n_layers
    assert all(k.shape == (2, 32, 4, cfg.hd) and k.any() for k, _ in cache["cross"])


def test_params_from_jax_splits_the_encoder_bit_for_bit():
    _, _, jparams, cfg, _, params = models(ARCH)
    jnp_tree = jax.tree.map(np.asarray, jparams)
    assert len(params["encoder"]) == cfg.encoder_layers and len(params["blocks"]) == cfg.n_layers
    leaves = jax.tree_util.tree_flatten_with_path(jnp_tree)[0]
    names = set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        names.add("/".join(keys))
        stacked = keys[0] in ("encoder", "blocks")
        copies = ([(params[keys[0]][i], leaf[i]) for i in range(leaf.shape[0])]
                  if stacked else [(params[keys[0]], leaf)])
        for t, want in copies:
            for key in keys[1:]:
                t = t[key]
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == want.tobytes(), keys
    # LayerNorm with a bias everywhere, the cross-attention's bias, no vision
    assert {"blocks/ln1/bias", "blocks/ln_c/bias", "blocks/cross/bq", "encoder/ln2/bias",
            "enc_norm/bias", "final_norm/bias"} <= names
    assert "encoder/cross/wq" not in names and "vis_proj/w" not in names
    # the seeded weights build the same tree
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = lambda tree, pre="": ({n for k, v in tree.items() for n in flat(v, f"{pre}{k}/")}
                                 if isinstance(tree, dict) else
                                 flat(tree[0], pre) if isinstance(tree, list) else {pre[:-1]})
    assert flat(mine) == names
