"""The port's yi-6b, qwen1.5-4b and minitron-4b against the JAX package's,
on the CPU.

Reduced configs (2 layers, d_model 256, heads of 32): yi-6b keeps its
grouped-query attention, qwen1.5-4b its QKV bias and full MHA,
minitron-4b its GELU MLP with biases.  The JAX model's weights go through
``params_from_jax``; prefill and decode logits must agree to 1e-4 of
max|logit|.  The GELU MLP alone must agree to float32 rounding, and the
exact (erf) GELU must not: ``jax.nn.gelu`` is the tanh approximation.
Bit-exact weights and decode against a prefill one token longer are in
``tests/test_torch_dense_decode.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as jax_layers
from tests._torch_parity import REL_TOL, jax_32bit, rel_err, torch  # noqa: F401
from tests.test_torch_rwkv import check_logits_match_jax
from repro_torch.models import layers as L

pytestmark = pytest.mark.jax              # the JAX model is the reference

ARCHS = ("yi-6b", "qwen1.5-4b", "minitron-4b")
F32_TOL = 1e-5                            # float32 rounding, of max|y|


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    cache = check_logits_match_jax(arch, 2)
    assert int(cache["layers"][0].pos.max()) == 12 + 3


def test_gelu_mlp_matches_jax_tanh_gelu():
    rng = np.random.default_rng(0)
    d, ff = 256, 512
    jp = jax_layers.init_mlp(jax.random.PRNGKey(0), d, ff, "gelu")
    # nonzero biases, so both are exercised
    jp = {k: jnp.asarray(0.1 * rng.standard_normal(v.shape), jnp.float32)
          if k.startswith("b_") else v for k, v in jp.items()}
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    want = np.asarray(jax_layers.apply_mlp(jp, jnp.asarray(x), "gelu"))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(p) == {"w_up", "b_up", "w_down", "b_down"}
    got = L.apply_mlp(p, torch.from_numpy(x), "gelu")
    assert rel_err(got, want) <= F32_TOL
    xt = torch.from_numpy(x)
    erf = torch.nn.functional.gelu(xt @ p["w_up"] + p["b_up"]) @ p["w_down"] + p["b_down"]
    assert rel_err(erf, want) > REL_TOL
    shapes = {k: tuple(v.shape) for k, v in L.init_mlp(
        torch.Generator().manual_seed(0), d, ff, "cpu", "gelu").items()}
    assert shapes == {k: tuple(v.shape) for k, v in jp.items()}
