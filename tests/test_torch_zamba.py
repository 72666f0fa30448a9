"""The port's zamba2-2.7b model and engine against the JAX package's, on
the CPU.

Reduced zamba2-2.7b with 4 layers: two groups, each the weight-tied shared
attention block (its own KV cache per application) followed by two Mamba2
layers (16 SSD heads of 32, state 16).  The checks are those of
``tests/test_torch_rwkv.py``: bit-exact weights, logits to 1e-4 of
max|logit|, decode against a prefill one token longer, and the engine's
tokens against the JAX engine's over three passes.
"""
import pytest

from tests._torch_parity import REL_TOL, jax_32bit  # noqa: F401
from tests.test_torch_rwkv import (check_decode_matches_prefill,
                                   check_engine_matches_jax,
                                   check_logits_match_jax,
                                   check_params_bit_exact, models)

pytestmark = pytest.mark.jax              # the JAX model is the reference

ARCH, LAYERS = "zamba2-2.7b", 4


def test_params_from_jax_is_bit_exact():
    leaves = check_params_bit_exact(ARCH, LAYERS)
    names = {"/".join(str(k.key) for k in path) for path, _ in leaves}
    assert {"shared_attn/attn/wq", "blocks/mamba/A_log", "blocks/mamba/conv_w"} <= names
    cfg = models(ARCH, LAYERS)[3]
    assert (cfg.shared_attn_every, cfg.n_layers // cfg.shared_attn_every) == (2, 2)


def test_prefill_and_decode_logits_match_jax():
    cache = check_logits_match_jax(ARCH, LAYERS)
    assert len(cache["shared"]) == 2
    assert all(int(sc.pos.max()) == 12 + 3 for sc in cache["shared"])
    assert float(cache["layers"][-1].ssm.abs().max()) > 0


def test_decode_matches_prefill_over_one_more_token():
    assert check_decode_matches_prefill(ARCH, LAYERS) > REL_TOL   # a stale state shows


def test_serving_engine_matches_jax_engine():
    check_engine_matches_jax(ARCH, LAYERS)
