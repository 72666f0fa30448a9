"""The port's step builders on a 1x1 mesh (a one-rank gloo group on the
CPU): the train step against ``loop.make_step`` and the JAX package's
``make_train_step``, gradient accumulation against one microbatch, and the
prefill and decode steps against the ``Model`` methods.

The steps run on DTensors (every placement is replicated on one rank);
their outputs are compared as whole tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.training.optimizer import AdamW as JaxAdamW
from tests._torch_parity import REL_TOL, jax_32bit, models, rel_err, torch  # noqa: F401
from tests._torch_train import PERTURB
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.models.convert import params_from_jax
from repro_torch.training.loop import make_step
from repro_torch.training.optimizer import AdamW
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.jax              # the JAX package is one reference

B, S = 2, 32
SHAPE = InputShape("reduced", S, B, "train")


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    m = make_smoke_mesh("cpu")
    yield m
    dist.destroy_process_group()


def whole(tree):
    """DTensor leaves as whole tensors (host ints and plain tensors kept)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def batch_of(cfg):
    return {k: torch.from_numpy(v) for k, v in next(make_pipeline(cfg, B, S, seed=0)).items()}


class GradsOut:
    """An optimizer whose update returns the gradients as the new params."""

    def init(self, params):
        return AdamW().init(params)

    def update(self, grads, state, params):
        return grads, state


def test_train_step_equals_loop_make_step_and_accumulates(mesh):
    """M = 1, remat off: the loss and updated params equal
    ``loop.make_step``'s within 1e-6 relative; M = 2: the loss and every
    gradient leaf equal M = 1's within 1e-4 of their max."""
    _, _, _, cfg, model, params = models("qwen3-4b")
    batch, opt = batch_of(cfg), AdamW()
    want_p, _, want_loss = make_step(model, opt)(params, opt.init(params), batch)
    st = steps.make_train_step("qwen3-4b", mesh, shape=SHAPE, cfg=cfg, remat=False,
                               microbatches=1, opt=opt)
    got_p, got_o, got_loss = whole(st.fn(*st.shard(params, opt.init(params), batch)))
    assert abs(float(got_loss) / float(want_loss) - 1) <= 1e-6
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert rel_err(g, w) <= 1e-6
    assert int(got_o.step) == 1

    grads = {}
    for M in (1, 2):
        st = steps.make_train_step("qwen3-4b", mesh, shape=SHAPE, cfg=cfg, remat=True,
                                   microbatches=M, opt=GradsOut())
        g, _, loss = whole(st.fn(*st.shard(params, AdamW().init(params), batch)))
        grads[M] = (float(loss), tree_leaves(g))
    assert abs(grads[2][0] / grads[1][0] - 1) <= 1e-4
    for a, b in zip(grads[2][1], grads[1][1]):
        assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max()) + 1e-12)


def test_train_step_equals_the_reference_builder(mesh, monkeypatch):
    """The JAX package's ``make_train_step`` on a 1x1 JAX mesh (the reduced
    config in place of the shape's), the same weights through
    ``params_from_jax`` and the same batch: the same loss (1e-5 relative)
    and updated params, each leaf within max(1e-4, twice its noise floor) of
    its max, the floor as ``tests/_torch_train.py`` takes it: how far the
    port's own update of that leaf moves when every weight is scaled by
    (1 + 1e-7 N(0, 1)).  A weight whose gradient is near zero moves by
    lr * g / (|g| + eps), which float32 noise in g swings."""
    jcfg, _, jparams, cfg, _, params = models("qwen3-4b")
    batch = batch_of(cfg)
    monkeypatch.setattr(jsteps, "effective_config", lambda arch, name: jcfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jst = jsteps.make_train_step("qwen3-4b", jmesh, shape=jshapes.InputShape(
        "reduced", S, B, "train"))
    jp = jax.tree.map(jnp.array, jparams)             # the step donates its params
    with jmesh:
        want_p, _, want_loss = jst.fn(jp, JaxAdamW().init(jp),
                                      {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    want_p = params_from_jax(jax.tree.map(np.asarray, want_p), cfg, "cpu")
    st = steps.make_train_step("qwen3-4b", mesh, shape=SHAPE, cfg=cfg)
    run = lambda p: whole(st.fn(*st.shard(p, AdamW().init(p), batch)))
    got_p, _, got_loss = run(params)
    assert abs(float(got_loss) / float(want_loss) - 1) <= 1e-5, (float(got_loss), want_loss)
    gen = torch.Generator().manual_seed(0)
    moved, _, _ = run(tree_map(lambda t: t * (1 + PERTURB * torch.randn(t.shape, generator=gen)),
                               params))
    for g, w, m in zip(tree_leaves(got_p), tree_leaves(want_p), tree_leaves(moved)):
        assert rel_err(g, w) <= max(REL_TOL, 2 * rel_err(m, g)), (rel_err(g, w), rel_err(m, g))


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_prefill_and_decode_steps_equal_the_model(mesh, arch):
    """The prefill step and three decode steps give the greedy tokens and
    the logits (1e-5 of max|logit|) of ``Model.prefill`` / ``decode_step``
    on the same weights and cache."""
    _, _, _, cfg, model, params = models(arch)
    prompt = batch_of(cfg)["tokens"]
    shape = InputShape("reduced", S + 4, B, "prefill")
    pre = steps.make_prefill_step(arch, mesh, shape=shape, cfg=cfg)
    dec = steps.make_decode_step(arch, mesh, shape=InputShape("reduced", S + 4, B, "decode"),
                                 cfg=cfg)

    cache = model.init_cache(B, S + 4, dtype=torch.float32)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    want = [logits]
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    for _ in range(3):
        lg, cache = model.decode_step(params, tok, cache)
        want.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)

    p, b, c = pre.shard(params, {"tokens": prompt},
                        model.init_cache(B, S + 4, dtype=torch.float32))
    logits, c = pre.fn(p, b, c)
    got = [whole(logits)]
    tok = got[0].argmax(-1).to(torch.int32)[:, None]
    got_toks = [tok]
    for _ in range(3):
        nxt, c = dec.fn(p, dec.place(1, tok), c)
        tok = whole(nxt)
        got_toks.append(tok)
    assert all(torch.equal(a, b) for a, b in zip(got_toks, toks)), (got_toks, toks)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert whole(c)["step"] == S + 3
