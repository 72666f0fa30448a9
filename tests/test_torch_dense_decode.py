"""The port's yi-6b, qwen1.5-4b and minitron-4b against the JAX package's,
on the CPU: ``params_from_jax`` copies every leaf bit for bit (the GELU
MLP's biases and qwen1.5-4b's QKV bias among them), and a decode step
after a prompt equals a prefill one token longer.  Logits against JAX
are in ``tests/test_torch_dense.py``.
"""
import pytest

from tests._torch_parity import jax_32bit  # noqa: F401
from tests.test_torch_dense import ARCHS
from tests.test_torch_rwkv import (check_decode_matches_prefill,
                                   check_params_bit_exact, models)

pytestmark = pytest.mark.jax              # the JAX model is the reference


def test_params_from_jax_is_bit_exact():
    names = {}
    for arch in ARCHS:
        leaves = check_params_bit_exact(arch, 2)
        names[arch] = {"/".join(str(k.key) for k in path) for path, _ in leaves}
    assert {"blocks/ffn/b_up", "blocks/ffn/b_down"} <= names["minitron-4b"]
    assert "blocks/ffn/w_gate" not in names["minitron-4b"]
    assert {"blocks/attn/bq", "blocks/attn/bk"} <= names["qwen1.5-4b"]
    cfgs = {arch: models(arch, 2)[3] for arch in ARCHS}
    assert cfgs["minitron-4b"].act_fn == "gelu"
    assert cfgs["qwen1.5-4b"].n_heads == cfgs["qwen1.5-4b"].n_kv_heads
    assert (cfgs["yi-6b"].n_heads, cfgs["yi-6b"].n_kv_heads) == (4, 1)   # reduced() keeps GQA


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_over_one_more_token(arch):
    check_decode_matches_prefill(arch, 2)
