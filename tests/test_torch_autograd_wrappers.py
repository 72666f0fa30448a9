"""The kernels' autograd wrappers on the CPU.

The raw wrappers (``ops.flash_attention``, ``ops.rwkv6_scan``,
``ops.ssd_scan``) have no backward: under grad mode an input that requires
grad is refused, naming the differentiable entry point, on the CPU as on
the card (a call under ``torch.no_grad`` or ``inference_mode``, as serving
makes, goes through).  ``FlashAttention``, ``RWKV6Scan`` and ``SSDScan``
differentiate the recompute (``full_attention``, ``wkv_chunked``,
``ssd_chunked``); their gradients equal autograd through the plain
versions in ``kernels/ref.py``, final states' gradients included.
"""
import numpy as np
import pytest

from tests._torch_parity import rel_err, torch
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M

RNG = np.random.default_rng(11)


def rand(*shape, scale=1.0):
    return torch.from_numpy((scale * RNG.standard_normal(shape)).astype(np.float32))


def flash_inputs():
    return (rand(2, 33, 4, 16), rand(2, 33, 2, 16), rand(2, 33, 2, 16)), {}


def rwkv_inputs():
    B, S, H, hd = 2, 40, 2, 16
    logw = torch.clamp(-torch.exp(rand(B, S, H, hd, scale=0.5) - 1.0), min=R.LOGW_CLAMP)
    return (rand(B, S, H, hd), rand(B, S, H, hd), rand(B, S, H, hd), logw,
            rand(H, hd, scale=0.1)), {"s0": rand(B, H, hd, hd, scale=0.1)}


def ssd_inputs(group=False):
    B, S, H, hd, N = 2, 40, 3, 8, 4
    shape_bc = (B, S, N) if group else (B, S, H, N)
    xdt = rand(B, S, H, hd)
    return (xdt, rand(*shape_bc), rand(*shape_bc), -torch.rand(B, S, H) * 0.5), \
        {"h0": rand(B, H, hd, N, scale=0.1)}


CASES = {"flash_attention": (ops.flash_attention, flash_inputs, "models.attention.flash_attention"),
         "rwkv6_scan": (ops.rwkv6_scan, rwkv_inputs, "models.rwkv.wkv"),
         "ssd_scan": (ops.ssd_scan, ssd_inputs, "models.ssm.ssd")}


@pytest.mark.parametrize("name", list(CASES))
def test_raw_wrapper_refuses_inputs_that_require_grad(name):
    kernel, make, entry = CASES[name]
    args, kw = make()
    kernel(*args, **kw)                                   # nothing requires grad
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name}: .*call repro_torch.{entry}"):
        kernel(*args, **kw)
    for mode in (torch.no_grad, torch.inference_mode):   # serving's modes
        with mode():
            kernel(*args, **kw)


def grads_of(fn, inputs, weights):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    return [o.detach() for o in outs], torch.autograd.grad(loss, ins)


def test_functions_backward_equal_autograd_through_ref():
    checks = []
    (q, k, v), _ = flash_inputs()
    for causal, window, kv in ((True, None, None), (True, 5, None), (False, None, 17)):
        kk, vv = (k, v) if kv is None else (k[:, :kv], v[:, :kv])
        w = [rand(*q.shape)]
        checks.append((lambda a, b, c: A.flash_attention(a, b, c, causal=causal, window=window),
                       lambda a, b, c: ref.attention_ref(a, b, c, causal=causal, window=window),
                       (q, kk, vv), w))
    args, kw = rwkv_inputs()
    w = [rand(*args[0].shape), rand(*kw["s0"].shape)]
    checks.append((lambda *a: R.wkv(*a[:5], s0=a[5]), lambda *a: ref.rwkv6_ref(*a),
                   (*args, kw["s0"]), w))
    (xh, Bm, Cm, dA), kw = ssd_inputs(group=True)
    dt = torch.rand(dA.shape) * 0.5
    B, S, H, N = *xh.shape[:3], Bm.shape[-1]
    w = [rand(*xh.shape), rand(*kw["h0"].shape)]
    checks.append((lambda x, b, c, d, a, h: M.ssd(x, b, c, d, a, h0=h),
                   lambda x, b, c, d, a, h: ref.ssd_ref(x * d[..., None], b[:, :, None].expand(B, S, H, N),
                                                        c[:, :, None].expand(B, S, H, N), a, h),
                   (xh, Bm, Cm, dt, dA, kw["h0"]), w))
    for fn, plain, inputs, weights in checks:
        outs, grads = grads_of(fn, inputs, weights)
        want_outs, want = grads_of(plain, inputs, weights)
        for a, b in zip(outs, want_outs):
            assert rel_err(a, b) <= 1e-5
        for a, b in zip(grads, want):
            assert a.dtype == b.dtype and rel_err(a, b) <= 1e-5
