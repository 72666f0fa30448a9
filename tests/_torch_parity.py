"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Each of those files holds at most four tests: pytest-xdist's ``loadfile``
schedule hands out the largest files first, so small files join the queue
last and leave the order of the existing files (and which of them share a
worker process) as it was.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import reduced as jax_reduced
from repro.models.zoo import build_model as jax_build_model

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402

REL_TOL = 1e-4          # of max|logit|, as in tests/test_decode_consistency.py


@pytest.fixture(autouse=True)
def jax_32bit():
    """Some modules of the JAX package switch JAX to 64-bit for the whole
    process when imported; the model and kernel references run in JAX's
    default 32-bit mode."""
    with jax.enable_x64(False):
        yield


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


@functools.lru_cache(maxsize=None)
def models(arch):
    """Reduced ``arch`` in both packages, sharing the JAX model's weights:
    (jax cfg, jax model, jax params, cfg, model, params)."""
    with jax.enable_x64(False):
        jcfg = jax_reduced(JAX_REGISTRY[arch])
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(7))
    cfg = reduced(REGISTRY[arch])
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, "cpu"), params
