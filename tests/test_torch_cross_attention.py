"""Cross-attention in the port against the JAX package's, on the CPU.

``flash_attention`` takes a kv length of its own (Skv != S) when it has no
mask: its plain version (the CPU path) must match the JAX oracle
``attention.full_attention(causal=False)`` to the float32 contract 2e-5,
and a causal or windowed call at Skv != S must be refused.  At decode the
port sends whisper's cross-attention through ``decode_attention`` with q
at position Se - 1 over slots 0..Se-1, which must equal the reference's
``attention_decode(cross_kv=)``; the self cache's position instead drops
every frame past it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as jax_attention
from tests._torch_parity import jax_32bit, models, rel_err, torch  # noqa: F401
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A

pytestmark = pytest.mark.jax              # the JAX functions are the reference

F32_TOL = 2e-5
full_attention = jax.jit(jax_attention.full_attention,
                         static_argnames=("causal", "window"))


def _positions(B, n):
    return jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (B, n))


def test_attention_ref_at_another_kv_length_matches_jax():
    rng = np.random.default_rng(0)
    B = 2
    for S, Skv, H, KV, hd in [(8, 32, 4, 4, 32), (1, 33, 4, 2, 32), (63, 31, 8, 1, 64),
                              (5, 1, 2, 2, 64), (16, 16, 4, 2, 32)]:
        q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
        k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
        v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
        want = np.asarray(full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         q_positions=_positions(B, S),
                                         kv_positions=_positions(B, Skv),
                                         causal=False, window=None))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        for got in (ops.flash_attention(tq, tk, tv, causal=False),
                    ref.attention_ref(tq, tk, tv, causal=False)):
            assert got.shape == (B, S, H, hd)
            np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL,
                                       err_msg=str((S, Skv)))


def test_flash_refuses_a_masked_call_at_another_kv_length():
    q = torch.zeros((1, 8, 2, 32))
    kv = torch.zeros((1, 32, 2, 32))
    before = ops.launch_counts()
    for kw in ({"causal": True}, {"causal": False, "window": 4}, {"causal": True, "window": 4}):
        with pytest.raises(ValueError, match="kv length 32 != 8"):
            ops.flash_attention(q, kv, kv, **kw)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q, kv[:, :0], kv[:, :0], causal=False)
    assert ops.launch_counts() == before
    assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape
    assert ops.flash_attention(q, kv[:, :8], kv[:, :8], causal=True, window=4).shape == q.shape


def _cross_inputs(seed, Se=33, S=5):
    """Reduced whisper's first decoder block's cross-attention weights, an
    encoder output of Se frames and a prompt of S tokens; a self cache
    whose write position is S (the reference's q position)."""
    jcfg, _, jparams, cfg, _, params = models("whisper-large-v3")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["cross"])
    p = params["blocks"][0]["cross"]
    rng = np.random.default_rng(seed)
    B = 2
    enc = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = jax_attention.init_kv_cache(B, 16, jcfg, dtype=jnp.float32)
    kv = kv._replace(pos=jnp.full((B,), S, jnp.int32))
    return jcfg, jp, cfg, p, enc, x, x1, kv


def test_cross_attention_prefill_and_decode_match_jax():
    jcfg, jp, cfg, p, enc, x, x1, kv = _cross_inputs(1)
    want = jax_attention.attention_forward(jp, jnp.asarray(x), jcfg, causal=False,
                                           x_kv=jnp.asarray(enc))
    k, v = A.project_kv(p, torch.from_numpy(enc), cfg)
    assert k.shape == (2, 33, cfg.n_kv_heads, cfg.hd)
    got = A.cross_attention_prefill(p, torch.from_numpy(x), cfg, k, v)
    assert rel_err(got, want) <= F32_TOL
    jk, jv = jax_attention._project_qkv(jp, jnp.asarray(enc), jnp.asarray(enc), jcfg)[1:]
    want, _, _ = jax_attention.attention_decode(jp, jnp.asarray(x1), jcfg, kv, cross_kv=(jk, jv))
    got = A.cross_attention_decode(p, torch.from_numpy(x1), cfg, k, v)
    assert got.shape == (2, 1, cfg.d_model)
    assert rel_err(got, want) <= F32_TOL


def test_self_cache_position_would_drop_frames():
    """decode_attention masks kv position <= q position: at the self
    cache's position 5 it sees 6 of 33 frames and leaves the reference."""
    jcfg, jp, cfg, p, enc, x, x1, kv = _cross_inputs(2)
    jk, jv = jax_attention._project_qkv(jp, jnp.asarray(enc), jnp.asarray(enc), jcfg)[1:]
    want, _, _ = jax_attention.attention_decode(jp, jnp.asarray(x1), jcfg, kv, cross_kv=(jk, jv))
    k, v = A.project_kv(p, torch.from_numpy(enc), cfg)
    q = A._project_q(p, torch.from_numpy(x1), cfg)
    Se = k.shape[1]
    slots = torch.arange(Se, dtype=torch.int32)[None].expand(2, Se)

    def through_decode(q_pos):
        o = ops.decode_attention(q, k, v, torch.full((2,), q_pos, dtype=torch.int32), slots)
        return o.reshape(2, 1, -1) @ p["wo"]

    assert rel_err(through_decode(Se - 1), want) <= F32_TOL
    assert rel_err(through_decode(int(kv.pos[0])), want) > 100 * F32_TOL
