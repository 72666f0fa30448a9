"""The port's scan kernels against the JAX package's.

On the CPU the port's ``ops.rwkv6_scan`` / ``ops.ssd_scan`` run their
plain PyTorch versions; these are held against the Pallas kernels in
interpret mode and against the JAX oracles in ``repro.kernels.ref`` on the
shape grid of ``tests/test_kernels.py`` at its scan tolerances (5x: f32
1e-4, bf16 1e-1); their initial states against the models' chunked scans
(``wkv_chunked(s0=)``, ``ssd_chunked(h0=)``); a ragged S against the
oracles alone.  Inputs are made with numpy and handed to both frameworks.
The CUDA kernels themselves run on the card in ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.models.rwkv import wkv_chunked
from repro.models.ssm import ssd_chunked
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.kernels import ops

pytestmark = pytest.mark.jax              # Pallas kernels in interpret mode

rwkv6_ref = jax.jit(jref.rwkv6_ref)
ssd_ref = jax.jit(jref.ssd_ref)

TOL = {"float32": 1e-4, "bfloat16": 1e-1}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(JNP[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TORCH[dtype]))


def _close(t, j, dtype, case):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], err_msg=str(case))


def _rwkv_inputs(rng, B, S, H, hd, dtype):
    """r, k, v, logw, u as tests/test_kernels.py draws them (logw clamped)."""
    n = lambda *shape: rng.standard_normal(shape)
    arrays = (0.5 * n(B, S, H, hd), 0.5 * n(B, S, H, hd), n(B, S, H, hd),
              np.maximum(-np.exp(0.5 * n(B, S, H, hd) - 1.5), -2.0), 0.3 * n(H, hd))
    return tuple(zip(*(_pair(a, dtype) for a in arrays)))


def _ssd_inputs(rng, B, S, H, hd, N, dtype):
    """xdt, Bm, Cm (per head) in ``dtype`` and dA in float32, as
    tests/test_kernels.py draws them."""
    n = lambda *shape: rng.standard_normal(shape)
    arrays = (n(B, S, H, hd), 0.5 * n(B, S, H, N), 0.5 * n(B, S, H, N))
    jx, tx = zip(*(_pair(a, dtype) for a in arrays))
    ja, ta = _pair(-np.exp(0.5 * n(B, S, H) - 1.5), "float32")
    return jx + (ja,), tx + (ta,)


# test_kernels.py's grid: (S, H, hd, q_chunk of the Pallas kernel); the
# port's kernel always cuts 32 (rwkv6) or 128 (ssd) steps per chunk.
# Every shape in f32, and bf16 on the widest (each case runs the Pallas
# kernel in interpret mode).
RWKV_CASES = ([(s, "float32") for s in [(128, 2, 32, 32), (256, 4, 64, 64), (64, 2, 32, 16)]]
              + [((256, 4, 64, 64), "bfloat16")])
SSD_CASES = ([(s, "float32") for s in [(128, 2, 32, 16, 32), (256, 4, 64, 64, 64)]]
             + [((256, 4, 64, 64, 64), "bfloat16")])


def test_scans_match_pallas():
    rng = np.random.default_rng(0)
    B = 2
    for (S, H, hd, q), dtype in RWKV_CASES:
        jin, tin = _rwkv_inputs(rng, B, S, H, hd, dtype)
        y, s = ops.rwkv6_scan(*tin)
        assert y.dtype == TORCH[dtype] and s.dtype == torch.float32
        jy, js = jax_rwkv6(*jin, q_chunk=q, interpret=True)
        _close(y, jy, dtype, ("rwkv6 pallas", S, H, hd, dtype))
        _close(s, js, dtype, ("rwkv6 pallas state", S, H, hd, dtype))
        ry, rs = rwkv6_ref(*jin)
        _close(y, ry, dtype, ("rwkv6 ref", S, H, hd, dtype))
        _close(s, rs, dtype, ("rwkv6 ref state", S, H, hd, dtype))
    for (S, H, hd, N, q), dtype in SSD_CASES:
        jin, tin = _ssd_inputs(rng, B, S, H, hd, N, dtype)
        y, h = ops.ssd_scan(*tin)
        assert y.dtype == TORCH[dtype] and h.dtype == torch.float32
        jy, jh = jax_ssd(*jin, q_chunk=q, interpret=True)
        _close(y, jy, dtype, ("ssd pallas", S, H, hd, N, dtype))
        _close(h, jh, dtype, ("ssd pallas state", S, H, hd, N, dtype))
        ry, rh = ssd_ref(*jin)
        _close(y, ry, dtype, ("ssd ref", S, H, hd, N, dtype))
        _close(h, rh, dtype, ("ssd ref state", S, H, hd, N, dtype))


def test_scans_start_from_an_initial_state():
    """s0 / h0 against the JAX models' chunked scans.  For wkv_chunked only
    lengths whose divisor-chosen chunk is <= 32 steps (S = 64: 32, S = 96:
    32): a longer chunk can overflow float32 (ROADMAP Queue 3)."""
    rng = np.random.default_rng(1)
    B, H, hd = 2, 2, 32
    for S in (64, 96):
        jin, tin = _rwkv_inputs(rng, B, S, H, hd, "float32")
        js0, ts0 = _pair(0.1 * rng.standard_normal((B, H, hd, hd)), "float32")
        y, s = ops.rwkv6_scan(*tin, s0=ts0)
        jy, js = wkv_chunked(*jin, q=32, s0=js0)
        _close(y, jy, "float32", ("wkv_chunked", S))
        _close(s, js, "float32", ("wkv_chunked state", S))
    # ssd_chunked takes x and dt apart, B/C in group form (B, S, N), and adds
    # the D skip; the port's block passes x * dt and B/C expanded over heads
    N = 16
    for S in (96, 256):
        n = lambda *shape: rng.standard_normal(shape)
        (jx, tx), (jdt, tdt), (jb, tb), (jc, tc), (jh0, th0) = (
            _pair(a, "float32") for a in (n(B, S, H, hd), np.exp(0.5 * n(B, S, H) - 2.0),
                                          0.5 * n(B, S, N), 0.5 * n(B, S, N),
                                          0.1 * n(B, H, hd, N)))
        A = -np.exp(np.log(np.linspace(1.0, 16.0, H)))
        D = np.ones(H, np.float32)
        y, h = ops.ssd_scan(tx * tdt[..., None], tb[:, :, None].expand(B, S, H, N),
                            tc[:, :, None].expand(B, S, H, N),
                            tdt * torch.from_numpy(A.astype(np.float32)), h0=th0)
        y = y + tx * torch.from_numpy(D)[None, None, :, None]
        jy, jh = ssd_chunked(jx, jb, jc, jdt, jdt * jnp.asarray(A, jnp.float32),
                             jnp.asarray(D), q=128, h0=jh0)
        _close(y, jy, "float32", ("ssd_chunked", S))
        _close(h, jh, "float32", ("ssd_chunked state", S))


def test_scans_ragged_length_and_continuation():
    """S = 100 and 513 are no multiple of any chunk; the Pallas kernels
    refuse them (and wkv_chunked's divisor-chosen chunk overflows at S =
    513), so the port is held against the JAX oracles alone.  Two calls,
    the second from the first's state, equal one call over both parts."""
    rng = np.random.default_rng(2)
    B, H, hd, N = 2, 2, 32, 16
    for S in (100, 513):
        jin, tin = _rwkv_inputs(rng, B, S, H, hd, "float32")
        y, s = ops.rwkv6_scan(*tin)
        ry, rs = rwkv6_ref(*jin)
        _close(y, ry, "float32", ("rwkv6 ragged", S))
        _close(s, rs, "float32", ("rwkv6 ragged state", S))
        y1, s1 = ops.rwkv6_scan(*(t[:, :37] for t in tin[:4]), tin[4])
        y2, s2 = ops.rwkv6_scan(*(t[:, 37:] for t in tin[:4]), tin[4], s0=s1)
        _close(torch.cat([y1, y2], 1), ry, "float32", ("rwkv6 continuation", S))
        _close(s2, rs, "float32", ("rwkv6 continuation state", S))

        jin, tin = _ssd_inputs(rng, B, S, H, hd, N, "float32")
        y, h = ops.ssd_scan(*tin)
        ry, rh = ssd_ref(*jin)
        _close(y, ry, "float32", ("ssd ragged", S))
        _close(h, rh, "float32", ("ssd ragged state", S))
        y1, h1 = ops.ssd_scan(*(t[:, :37] for t in tin))
        y2, h2 = ops.ssd_scan(*(t[:, 37:] for t in tin), h0=h1)
        _close(torch.cat([y1, y2], 1), ry, "float32", ("ssd continuation", S))
        _close(h2, rh, "float32", ("ssd continuation state", S))

    # decays at the clamp: wkv_chunked picks Q = 57 for S = 513 (509 for
    # S = 509) and overflows; the port's fixed 32-step chunks do not
    for S, want_q in ((513, 57), (509, 509)):
        jin, tin = _rwkv_inputs(rng, 1, S, H, hd, "float32")
        lw = -2.0 + 0.01 * np.abs(rng.standard_normal((1, S, H, hd)))
        (jlw, tlw), = [_pair(lw, "float32")]
        jin, tin = jin[:3] + (jlw, jin[4]), tin[:3] + (tlw, tin[4])
        assert S // max(n for n in range(1, S // 32 + 1) if S % n == 0) == want_q
        jy, _ = wkv_chunked(*jin, q=32)
        assert not np.isfinite(np.asarray(jy)).all(), S
        y, s = ops.rwkv6_scan(*tin)
        ry, rs = rwkv6_ref(*jin)
        _close(y, ry, "float32", ("rwkv6 at the clamp", S))
        _close(s, rs, "float32", ("rwkv6 at the clamp, state", S))


def test_scan_wrappers_refuse_bad_inputs_and_count_no_cpu_launch():
    ops.reset_launch_counts()
    x = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        m = x.to("meta")
        ops.rwkv6_scan(m, m, m, m, torch.zeros((2, 32), device="meta"))
    with pytest.raises(ValueError):
        ops.rwkv6_scan(x, x, x, x, torch.zeros((3, 32)))
    with pytest.raises(ValueError):
        ops.rwkv6_scan(x, x, x, x, torch.zeros((2, 32)), s0=torch.zeros((1, 2, 32, 16)))
    bc = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, bc, bc, torch.zeros((1, 8, 3)))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, bc, bc, torch.zeros((1, 8, 2)), h0=torch.zeros((1, 2, 16, 32)))
    y, s = ops.rwkv6_scan(x, x, x, x, torch.zeros((2, 32)))
    y2, h = ops.ssd_scan(x, bc, bc, torch.zeros((1, 8, 2)))
    assert (y.shape, s.shape, y2.shape, h.shape) == (
        (1, 8, 2, 32), (1, 2, 32, 32), (1, 8, 2, 32), (1, 2, 32, 16))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_mla": 0,
                                   "decode_attention": 0,
                                   "decode_attention_partial": 0,
                                   "rwkv6_scan": 0, "ssd_scan": 0, "moe_experts": 0,
                                   "gemm": 0, "alloc_all": 0, "tables": 0}
