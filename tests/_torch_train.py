"""Shared set-up of the port's training parity tests: the loss and every
gradient leaf of the port's ``Model.loss`` against ``jax.value_and_grad``
of the JAX package's ``train_loss``, on the data pipeline's batches.

Per-leaf error is max|g - g_jax| / max|g_jax|.  Its bound is the larger of
1e-4 and twice the leaf's float32 noise floor: how far the port's own
gradient of that leaf moves when every weight is scaled by (1 + 1e-7 N(0,
1)).  The floor is far below 1e-4 for every reduced model but rwkv6-1.6b:
at t = 0 its state is zero, so y_0 = (r_0 . (u * k_0)) v_0, a cancelling dot
product times v_0, and 1.5 % of its (token, head) rows reach the group
norm with a variance under its eps (64e-5); there a 1e-7 change of the
weights moves block 0's gradients by 2e-4 of their max, in either package.
A leaf whose exact gradient is zero (the key bias of an attention
without rotary positions, whisper's: softmax does not see a shift of
every score) holds rounding noise only, and its floor says so.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as jax_transformer
from tests._torch_parity import REL_TOL, models, rel_err, torch
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

BATCH, SEQ = 2, 32
PERTURB = 1e-7


def port_loss_and_grads(params, cfg, batch, *, remat):
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(params)]
    loss = T.train_loss(tree_unflatten(params, leaves), cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss), grads


def noise_floor(params, cfg, batch, grads, seed=0):
    """Per leaf: how far the gradient moves under a 1e-7 relative change of
    every weight (the float32 noise floor of that leaf's gradient)."""
    gen = torch.Generator().manual_seed(seed)
    moved = [t * (1 + PERTURB * torch.randn(t.shape, generator=gen))
             for t in tree_leaves(params)]
    _, g = port_loss_and_grads(tree_unflatten(params, moved), cfg, batch, remat=False)
    return [rel_err(a, b) for a, b in zip(g, grads)]


def check_against_jax(arch):
    """Loss within 1e-5 relative and every gradient leaf within its bound,
    with remat off and on (which must give the same gradients).  Returns
    the largest noise floor of a leaf whose exact gradient is not zero
    (all but the key biases ``bk`` of a model without rotary positions)."""
    jcfg, _, jparams, cfg, _, params = models(arch)
    batch = next(make_pipeline(cfg, BATCH, SEQ, seed=0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_transformer.train_loss(p, jcfg, jb, remat=False))(jparams)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = port_loss_and_grads(params, cfg, tb, remat=False)
    assert abs(loss / float(jloss) - 1) <= 1e-5, (loss, float(jloss))
    floor = noise_floor(params, cfg, tb, grads)
    bad = {}
    for name, g, w, n in zip(tree_paths(want), grads, tree_leaves(want), floor):
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.isfinite(g).all(), name
        err = rel_err(g, w)
        if err > max(REL_TOL, 2 * n):
            bad[name] = (err, n)
    assert not bad, bad
    loss_r, grads_r = port_loss_and_grads(params, cfg, tb, remat=True)
    assert loss_r == loss
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads))
    return max(n for name, n in zip(tree_paths(want), floor)
               if not (name.endswith(".bk") and cfg.rope_theta <= 0))
