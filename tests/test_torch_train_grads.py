"""The port's training loss and gradients against the JAX package's, on
the CPU: reduced qwen3-4b, mixtral-8x22b (the MoE aux loss and the
router's gradient through top-k, capacity and the combine), rwkv6-1.6b and
zamba2-2.7b (the scans' autograd wrappers, zamba2's shared attention
block), with shared weights and the data pipeline's batch (2 x 32).

Each runs ``Model.loss`` through ``FlashAttention`` / ``RWKV6Scan`` /
``SSDScan`` (forward the kernels' plain versions, backward the recompute)
and ``jax.value_and_grad(train_loss)``; remat on and off must give the
same gradients.  Bounds: ``tests/_torch_train.py``.
"""
import pytest

from tests._torch_parity import jax_32bit  # noqa: F401
from tests._torch_train import check_against_jax

pytestmark = pytest.mark.jax              # the JAX model is the reference


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_loss_and_grads_match_jax(arch):
    floor = check_against_jax(arch)
    # the noise floor widens the bound only where the model is ill-conditioned
    assert floor < (1e-3 if arch == "rwkv6-1.6b" else 2e-5), floor
