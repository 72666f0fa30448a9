"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held against the Pallas kernels in interpret mode and against the
JAX oracles in ``repro.kernels.ref``, on the shape grid of
``tests/test_kernels.py`` with its tolerances (f32 2e-5, bf16 2e-2).
Inputs are made with numpy and handed to both frameworks.  The CUDA
kernels themselves run on the card in ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.kernels import ops

pytestmark = pytest.mark.jax              # Pallas kernels in interpret mode

# the JAX oracles, compiled once per shape (eager op-by-op dispatch is slow)
attention_ref = jax.jit(jref.attention_ref, static_argnames=("causal", "window"))
decode_attention_ref = jax.jit(jref.decode_attention_ref,
                               static_argnames=("window",))

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(JNP[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TORCH[dtype]))


def _close(t, j, dtype, case):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], err_msg=str(case))


FLASH_SHAPES = [(128, 4, 4, 64),      # MHA
                (256, 8, 2, 64),      # GQA 4:1
                (256, 4, 1, 128)]     # MQA, wide head
DECODE_SHAPES = [(512, 4, 2, 64, 128), (1024, 8, 8, 64, 256),
                 (256, 4, 1, 128, 64)]
# a subset of test_kernels.py's grid: every shape and mask in f32, and bf16
# on the widest head (each case compiles the Pallas kernel in interpret mode).
# Each test loops over its cases: see tests/_torch_parity.py for why.
FLASH_CASES = ([(*s, "float32", c, w) for s in FLASH_SHAPES
                for c, w in [(True, None), (False, None), (True, 64)]]
               + [(*FLASH_SHAPES[2], "bfloat16", True, 64)])
DECODE_CASES = ([(*s, "float32", None) for s in DECODE_SHAPES]
                + [(*DECODE_SHAPES[0], "float32", 128),
                   (*DECODE_SHAPES[2], "bfloat16", 128)])


def test_flash_attention_matches_pallas():
    rng = np.random.default_rng(0)
    B = 2
    for case in FLASH_CASES:
        S, H, KV, hd, dtype, causal, window = case
        qj, qt = _pair(rng.standard_normal((B, S, H, hd)), dtype)
        kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
        vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
        out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
        assert out.shape == (B, S, H, hd) and out.dtype == TORCH[dtype], case
        _close(out, jax_flash(qj, kj, vj, causal=causal, window=window, bq=64,
                              bk=64, interpret=True), dtype, case)
        _close(out, attention_ref(qj, kj, vj, causal=causal, window=window),
               dtype, case)


def test_flash_attention_ragged_length():
    """S = 100 is no multiple of any tile; the Pallas kernel refuses it, so
    the port is held against the JAX oracle alone."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 100, 4, 2, 32
    for window in (None, 16):
        qj, qt = _pair(rng.standard_normal((B, S, H, hd)), "float32")
        kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
        vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
        out = ops.flash_attention(qt, kt, vt, causal=True, window=window)
        _close(out, attention_ref(qj, kj, vj, causal=True, window=window),
               "float32", window)


def test_decode_attention_matches_pallas():
    rng = np.random.default_rng(1)
    B = 2
    for case in DECODE_CASES:
        S, H, KV, hd, bk, dtype, window = case
        qj, qt = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
        kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
        vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
        qpos = np.asarray([S // 2, S - 1], np.int32)
        kvpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
        out = ops.decode_attention(qt, kt, vt, torch.from_numpy(qpos),
                                   torch.from_numpy(kvpos.copy()), window=window)
        assert out.shape == (B, 1, H, hd) and out.dtype == TORCH[dtype], case
        _close(out, jax_decode(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(kvpos),
                               window=window, bk=bk, interpret=True), dtype, case)
        _close(out, decode_attention_ref(qj, kj, vj, jnp.asarray(qpos),
                                         jnp.asarray(kvpos), window=window),
               dtype, case)


def test_decode_attention_rolling_slots():
    """-1 (unwritten) rolling slots are masked; a row with no valid slot
    returns mean(V) in both packages, not NaN."""
    rng = np.random.default_rng(5)
    B, S, H, KV, hd = 2, 128, 2, 2, 64
    qj, qt = _pair(rng.standard_normal((B, 1, H, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
    kvpos = np.stack([np.where(np.arange(S) < 100, np.arange(S), -1),
                      np.full(S, -1)]).astype(np.int32)
    qpos = np.asarray([99, 99], np.int32)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(qpos),
                               torch.from_numpy(kvpos))
    _close(out, jax_decode(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(kvpos),
                           bk=64, interpret=True), "float32", "rolling")
    mean_v = np.repeat(np.asarray(vt[1].mean(0)), H // KV, axis=0)
    np.testing.assert_allclose(out[1, 0].numpy(), mean_v, atol=2e-5)
    assert torch.isfinite(out).all()
