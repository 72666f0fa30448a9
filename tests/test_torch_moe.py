"""The port's MoE layer against the JAX package's, on the CPU.

``apply_moe`` (the gathered, batched-expert path) and ``moe_plain`` (the
reference's one-hot einsums) must give the reference ``apply_moe``'s
output and aux loss to float32 rounding, route to the same experts and
drop the same assignments: where the capacity binds, under
``expert_shards=2`` (the reference counts an assignment's position once
per virtual shard, so an expert keeps half its slots), at dbrx's top-4
of 8 routing, and on exact ties (the lower expert index wins, as in
``jax.lax.top_k``).  Decode's one-token chunk and a sequence long enough
for two chunks are in ``tests/test_torch_moe_decode.py``, the models in
``tests/test_torch_moe_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import moe as jax_moe
from tests._torch_parity import jax_32bit, rel_err, torch  # noqa: F401
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import moe

pytestmark = pytest.mark.jax              # the JAX layer is the reference

F32_TOL = 1e-5                            # float32 rounding, of max|y|

# (case, B, S, chunk, config overrides of reduced mixtral-8x22b)
LAYER_CASES = [
    ("capacity binds", 2, 64, 512, {"capacity_factor": 1.0}),
    ("expert_shards=2", 2, 64, 512, {"expert_shards": 2}),
    ("dbrx top-4 of 8", 2, 64, 512, {"n_experts": 8, "top_k": 4, "capacity_factor": 1.0}),
    ("ties", 2, 16, 512, {}),
    ("decode", 4, 1, 1, {"expert_shards": 2}),               # tests/test_torch_moe_decode.py
    ("two chunks", 1, 8200, 512, {"d_model": 16, "d_ff": 32, "top_k": 1,
                                  "capacity_factor": 1.0}),
]


def reference_chunking(S, cfg, chunk):
    """(chunks, tokens a chunk, capacity) by the reference apply_moe's own
    formula, written out here so that the dropped set does not rest on the
    port's choice of chunks."""
    E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    chunk = max(chunk, min(S, 4096))
    n = max(1, S // chunk)
    while S % n:
        n -= 1
    return n, S // n, max(K, int(np.ceil(S // n * K * cf / E)))


def reference_kept(jp, x, cfg, chunk):
    """The reference's kept assignments, (B, S, K) bool, read off its
    dispatch tensor chunk by chunk (an expert is picked once a token)."""
    B, S, _ = x.shape
    E, K, ks = cfg.n_experts, cfg.top_k, cfg.expert_shards
    n, Sc, C = reference_chunking(S, cfg, chunk)
    ids, gates, _ = jax_moe._route(jp["router"], jnp.asarray(x), K)
    kept = []
    for i in range(n):
        idc = ids[:, i * Sc:(i + 1) * Sc]
        dispatch, _ = jax_moe._dispatch_combine(idc, gates[:, i * Sc:(i + 1) * Sc], E, C, ks)
        per_expert = np.asarray(dispatch).sum(-1)                # (B, Sc, E·ks)
        kept.append(np.take_along_axis(per_expert, np.asarray(idc) * ks, -1) > 0)
    return np.concatenate(kept, 1)


def check_apply_moe(case, B, S, chunk, overrides):
    """apply_moe and moe_plain against the reference apply_moe on one case of
    LAYER_CASES: output, aux loss, routed ids and dropped set."""
    cfg = reduced(REGISTRY["mixtral-8x22b"]).replace(**overrides)
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), cfg)
    if case == "ties":
        jp["router"] = jnp.zeros_like(jp["router"])
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want, want_aux = jax_moe.apply_moe(jp, jnp.asarray(x), cfg, chunk=chunk)
    kept = reference_kept(jp, x, cfg, chunk)

    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    xt = torch.from_numpy(x)
    moe.reset_drop_counts()
    y, aux = moe.apply_moe(p, xt, cfg, chunk=chunk, layer=3)
    dropped, total = moe.drop_counts()[3]
    y_plain, aux_plain = moe.moe_plain(p, xt, cfg, chunk=chunk)
    assert moe.drop_counts() == {3: (dropped, total)}          # the plain version counts nothing
    for got, got_aux in ((y, aux), (y_plain, aux_plain)):
        assert got.shape == (B, S, cfg.d_model)
        assert rel_err(got, want) <= F32_TOL
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    # the same assignments dropped
    n, Sc, C = reference_chunking(S, cfg, chunk)
    assert moe._chunking(S, cfg, chunk) == (n, Sc, C)
    ids, _, _ = moe._route(p["router"], xt, cfg.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(jax_moe._route(jp["router"], jnp.asarray(x),
                                                                 cfg.top_k)[0]))
    keep = torch.cat([moe._positions(ids[:, i * Sc:(i + 1) * Sc], cfg.n_experts,
                                     cfg.expert_shards) < C for i in range(n)], 1)
    assert np.array_equal(keep.numpy().reshape(kept.shape), kept)
    assert (total, dropped) == (B * S * cfg.top_k, int((~kept).sum()))
    if case == "ties":
        assert (ids.numpy() == np.arange(cfg.top_k)).all()     # lower expert index first
    if case == "decode":
        assert dropped == 0
    elif case == "expert_shards=2":
        # position = 2 x rank: an expert keeps ceil(C / 2) of its C slots
        assert (C, dropped) == (40, 96)
    else:
        assert dropped > 0, case
    if case == "two chunks":
        assert n == 2


@pytest.mark.parametrize("case,B,S,chunk,overrides", LAYER_CASES[:4],
                         ids=[c[0] for c in LAYER_CASES[:4]])
def test_apply_moe_matches_reference(case, B, S, chunk, overrides):
    check_apply_moe(case, B, S, chunk, overrides)
