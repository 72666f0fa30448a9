"""The port's MoE layer in decode's one-token chunk and over two chunks of
a long sequence, against the JAX package's; and the reduced mixtral-8x22b
and dbrx-132b models' decode step against a prefill one token longer,
which holds only without drops (capacity factor expert_shards·E/K), on
the CPU.  The layer cases are ``tests/test_torch_moe.py``'s.
"""
import pytest

from tests._torch_parity import jax_32bit  # noqa: F401
from tests.test_torch_moe import LAYER_CASES, check_apply_moe
from tests.test_torch_rwkv import check_decode_matches_prefill, models
from repro_torch.models import moe

pytestmark = pytest.mark.jax              # the JAX layer and model are the reference


@pytest.mark.parametrize("case,B,S,chunk,overrides", LAYER_CASES[4:],
                         ids=[c[0] for c in LAYER_CASES[4:]])
def test_apply_moe_matches_reference(case, B, S, chunk, overrides):
    check_apply_moe(case, B, S, chunk, overrides)


@pytest.mark.parametrize("arch,shards", [("mixtral-8x22b", 2), ("dbrx-132b", 1)])
def test_decode_matches_prefill_without_drops(arch, shards):
    """chip_smoke.py's full-width check at CPU size, on a model whose
    capacity factor expert_shards·E/K drops nothing (C = ks·Sc)."""
    cfg = models(arch, 2, expert_shards=shards)[3]
    dropless = shards * cfg.n_experts / cfg.top_k
    moe.reset_drop_counts()
    check_decode_matches_prefill(arch, 2, expert_shards=shards, capacity_factor=dropless)
    assert all(d == 0 for d, _ in moe.drop_counts().values())
