"""The port's sharding resolution against the JAX package's, leaf for leaf.

Resolution reads only the mesh's axis sizes, so both packages resolve
against the same {axis: size} mapping on the 1x1, 16x16 and 2x16x16 mesh
shapes (no 256-device mesh is made).  The port keeps one dict per layer
and one cache per layer: each per-layer spec must equal the reference's
stacked spec without its leading (layer) entry.  Comparisons are exact.
"""
import functools

import jax
import pytest

from repro.configs import ASSIGNED
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.distributed import sharding as jsh
from repro.models import transformer as JT
from tests._torch_mesh import MESHES, entries, fake_mesh, pair_cache, pair_params, spec_tuple
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as T

pytestmark = pytest.mark.jax              # the JAX package is the reference


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    with jax.enable_x64(False):
        return JT.abstract_params(JAX_REGISTRY[arch]), JT.param_specs(JAX_REGISTRY[arch])


@pytest.mark.parametrize("drop", [frozenset(), frozenset({"fsdp"})], ids=["train", "serve"])
def test_param_specs_resolve_as_the_reference(drop):
    """Every assigned arch on every mesh shape, with and without fsdp (the
    serving steps' drop): the port's resolved per-layer specs equal the
    reference's stacked ones less their layer entry, and its abstract
    params (on the meta device) have the reference's shapes and dtypes."""
    for arch in ASSIGNED:
        jabs, jspecs = reference_params(arch)
        abstract = T.abstract_params(REGISTRY[arch])
        specs = T.param_specs(REGISTRY[arch])
        n = 0
        for name, mesh in MESHES.items():
            want = jsh.resolve_tree(jspecs, jabs, fake_mesh(mesh), drop)
            got = sh.resolve_tree(specs, abstract, mesh, drop)
            for path, g, w, stacked in pair_params(got, want):
                assert entries(g) == spec_tuple(w, stacked), (arch, name, path, g, w)
                n += 1
        for path, a, j, stacked in pair_params(abstract, jabs):
            assert a.device.type == "meta", (arch, path)
            shape = tuple(j.shape)[1:] if stacked else tuple(j.shape)
            assert tuple(a.shape) == shape and str(a.dtype).split(".")[-1] == str(j.dtype), \
                (arch, path, a.shape, j.shape, a.dtype, j.dtype)
        assert n == 3 * len(jax.tree.leaves(
            jax.tree.map(lambda a: 0, jabs))) + 3 * sum(
            len(jax.tree.leaves(jabs[k])) * (JAX_REGISTRY[arch].n_layers - 1 if k == "blocks"
                                             else JAX_REGISTRY[arch].encoder_layers - 1)
            for k in ("blocks", "encoder") if k in jabs), arch


CACHE_CASES = [
    # (arch, batch, max_len): whisper's L == batch == 32 collision; qwen3-4b
    # with KV == batch == 8; batch 1 (the longest dim shards); zamba2's
    # shared-attention caches and Mamba2 state; rwkv6's state; qwen2-vl's
    # M-RoPE offset; past 2048 slots for kv_seq_shard
    ("whisper-large-v3", 32, 64), ("qwen3-4b", 8, 4096), ("qwen3-4b", 1, 4096),
    ("zamba2-2.7b", 16, 4096), ("rwkv6-1.6b", 32, 64), ("qwen2-vl-7b", 16, 2048),
    ("mixtral-8x22b", 128, 2048),
]


def test_cache_specs_resolve_as_the_reference():
    """cache_specs on every case, mesh shape and policy equals the
    reference's, per layer against the stacked spec."""
    for arch, batch, max_len in CACHE_CASES:
        jcache = jax.eval_shape(lambda: JT.init_cache(JAX_REGISTRY[arch], batch, max_len))
        cache = T.init_cache(REGISTRY[arch], batch, max_len, device="meta")
        for name, mesh in MESHES.items():
            for kv_seq in (False, True):
                want = jsh.cache_specs(jcache, fake_mesh(mesh), batch=batch,
                                       policy=jsh.ActivationPolicy(kv_seq_shard=kv_seq))
                got = sh.cache_specs(cache, mesh, batch=batch,
                                     policy=sh.ActivationPolicy(kv_seq_shard=kv_seq))
                for path, g, w, stacked in pair_cache(got, want):
                    assert entries(g) == spec_tuple(w, stacked), \
                        (arch, batch, name, kv_seq, path, g, w)


def test_activation_hints_equal_the_reference():
    """ActivationPolicy.hints for every mesh shape, batch, decode flag and
    policy knob: residual, logits, kv and the MoE weight specs."""
    policies = [dict(), dict(shard_batch=False), dict(seq_shard_residual=False),
                dict(vocab_shard_logits=False), dict(kv_seq_shard=True)]
    for name, mesh in MESHES.items():
        for batch in (1, 8, 32, 256):
            for decode in (False, True):
                for kw in policies:
                    want = jsh.ActivationPolicy(**kw).hints(fake_mesh(mesh), batch=batch,
                                                            decode=decode)
                    got = sh.ActivationPolicy(**kw).hints(mesh, batch=batch, decode=decode)
                    for field in ("residual", "logits", "kv", "moe_w_in", "moe_w_out"):
                        w, g = getattr(want, field), getattr(got, field)
                        assert (w is None and g is None) or entries(g) == tuple(w), \
                            (name, batch, decode, kw, field, g, w)
                    assert got.moe_ep is None and got.mesh is None
