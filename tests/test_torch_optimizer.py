"""The port's AdamW against the JAX package's, on the CPU.

Identical gradients go through both for 5 steps, float32 and int8 moments
(``quant_min_size=16``), with the warm-up and cosine schedule, decay of
matrices only, and global-norm clipping on or off.  Params and float32
moments agree to 1e-6 of each leaf's largest value (elementwise, values
near zero carry the cancellation of p - lr * step), int8 codes equal.
With clipping the global norm sums in another order than XLA's: an ulp of
it, carried through 5 steps of moments, moves the int8 scales by a few
ulps (3 seen), so they agree to 1e-6 relative; without it they are equal.
Also the JAX package's own optimizer tests, mirrored.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training import optimizer as jax_opt
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.training.optimizer import (AdamW, QuantState, _dequantize, _quantize,
                                            choose_block, quantizable)

pytestmark = pytest.mark.jax              # the JAX optimizer is the reference

SHAPES = {"w": (4, 512), "bias": (300,), "experts": (2, 32, 64), "small": (8, 24)}


def close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) <= tol * np.max(np.abs(b))


def test_update_matches_jax():
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    for quant, clip in ((None, 1.0), (None, None), (16, 1.0), (16, None)):
        kw = dict(lr=0.05, warmup_steps=3, total_steps=10, weight_decay=0.1,
                  grad_clip=clip, quant_min_size=quant)
        jo, opt = jax_opt.AdamW(**kw), AdamW(**kw)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        js, ts = jo.init(jp), opt.init(tp)
        for _ in range(5):
            g = {k: (2 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
            jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert int(ts.step) == int(js.step) == 5
        for k in SHAPES:
            assert tp[k].dtype == torch.float32 and close(tp[k], jp[k]), (k, clip)
            for mine, theirs in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
                if isinstance(theirs, jax_opt.QuantState):
                    assert isinstance(mine, QuantState) and mine.q.dtype == torch.int8
                    assert (mine.q.numpy() == np.asarray(theirs.q)).all(), (k, clip)
                    a, b = mine.scale.numpy(), np.asarray(theirs.scale)
                    assert (np.abs(a - b) <= (1e-6 * np.abs(b) if clip else 0)).all(), (k, clip)
                else:
                    assert not isinstance(mine, QuantState) and close(mine, theirs), (k, clip)
        if quant:      # matrices quantized, vectors never
            assert isinstance(ts.mu["w"], QuantState) and not isinstance(ts.mu["bias"], QuantState)


def test_choose_block_and_quantizable_match_jax():
    shapes = [(8, 16384), (16, 6144, 10752), (100,), (4, 512), (8, 24), (3, 48), (2, 2560),
              (9728, 2560), (2560, 151936), (5, 32, 256), (7, 100), (1, 16), (4, 8)]
    for s in shapes:
        assert choose_block(s) == jax_opt.choose_block(s), s
        assert quantizable(s) == jax_opt.quantizable(s), s
    assert choose_block((8, 16384)) == 256
    b = choose_block((16, 6144, 10752))   # dbrx's F: 672 per 16-way shard
    assert b is not None and 10752 % b == 0 and (10752 // 16) % b == 0
    assert choose_block((100,)) is None
    x = torch.randn((8, 512), generator=torch.Generator().manual_seed(0)) * 3.0
    back = _dequantize(_quantize(x), x.shape)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 100
    with jax.enable_x64(False):
        qs = jax_opt._quantize(jnp.asarray(x.numpy()))
    mine = _quantize(x)
    assert (mine.q.numpy() == np.asarray(qs.q)).all()
    assert (mine.scale.numpy() == np.asarray(qs.scale)).all()


def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0, grad_clip=None)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_quantized_adam_converges_like_f32():
    def run(quant):
        opt = AdamW(lr=0.05, warmup_steps=1, total_steps=400, weight_decay=0.0,
                    grad_clip=None, quant_min_size=16 if quant else None)
        params = {"w": torch.ones((4, 512)) * 2.0}
        st = opt.init(params)
        for _ in range(100):
            params, st = opt.update({"w": 2 * params["w"]}, st, params)
        return float(params["w"].abs().max())
    f32, q8 = run(False), run(True)
    assert q8 < 0.2 and abs(q8 - f32) < 0.15
