"""The port's training loss and gradients against the JAX package's for
the encoder-decoder and the vision-language model, and the attention
gradient's long-sequence path, on the CPU.

Reduced whisper-large-v3 (the encoder over the pipeline's random frames,
cross-attention at a kv length of its own) and qwen2-vl-7b (the
pipeline's patches through the vision projection, M-RoPE): as
``tests/test_torch_train_grads.py``.  ``kv_blockwise_attention``, which
``FlashAttention``'s backward differentiates past 4096 positions, against
the JAX package's at S = 4100 (2 heads of 16): outputs and the vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as jax_attention
from tests._torch_parity import REL_TOL, jax_32bit, rel_err, torch  # noqa: F401
from tests._torch_train import check_against_jax
from repro_torch.models import attention as A

pytestmark = pytest.mark.jax              # the JAX model is the reference


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b"])
def test_loss_and_grads_match_jax(arch):
    assert check_against_jax(arch) < 2e-5


def test_kv_blockwise_attention_matches_jax_past_4096():
    for causal, window in ((True, None), (False, None), (True, 700)):
        check_kv_blockwise(causal, window)


def check_kv_blockwise(causal, window):
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 1, 4100, 2, 1, 16
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    kw = dict(causal=causal, window=window)
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_attention.kv_blockwise_attention(
        q_, k_, v_, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos), **kw),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tpos = torch.from_numpy(pos.copy())
    got = A.kv_blockwise_attention(*ins, q_positions=tpos, kv_positions=tpos, **kw)
    grads = torch.autograd.grad(got, ins, torch.from_numpy(g))
    assert rel_err(got.detach(), want) <= REL_TOL
    for a, b in zip(grads, want_grads):
        assert rel_err(a, b) <= REL_TOL
    # and the flash wrapper's backward takes this path at S > 4096
    flash = [t.detach().requires_grad_() for t in ins]
    out = A.flash_attention(*flash, **kw)
    assert rel_err(out.detach(), want) <= REL_TOL
    for a, b in zip(torch.autograd.grad(out, flash, torch.from_numpy(g)), grads):
        assert rel_err(a, b) <= 1e-6
