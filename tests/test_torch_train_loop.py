"""The port's training step, loop and launcher, on the CPU.

The step (``loop.make_step``: cast, loss, gradient, AdamW) for 3 steps
from carried-over params against the JAX loop's step body
(``value_and_grad`` of ``Model.loss`` on ``cast_params`` and
``opt.update``) on the same pipeline batches; the reference's short
training run mirrored; a run restored from its step-2 checkpoint
continuing as the uninterrupted run; ``python -m
repro_torch.launch.train`` on the CPU, and ``--dry-run`` handed to the dry run.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as jax_transformer
from repro.training.optimizer import AdamW as JaxAdamW
from tests._torch_parity import jax_32bit, models, torch  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax
from repro_torch.training import loop
from repro_torch.training.optimizer import AdamW
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.jax              # the JAX step is the reference


def test_three_steps_match_the_jax_step():
    jcfg, jmodel, jparams, cfg, model, params = models("qwen3-4b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=3, weight_decay=0.01)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)

    @jax.jit
    def jax_step(p, s, b):       # the JAX loop's step_fn
        def loss_fn(q):
            return jmodel.loss(jax_transformer.cast_params(q, jnp.float32), b, remat=False)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, s = jopt.update(grads, s, p)
        return p, s, loss

    step = loop.make_step(model, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    data = make_pipeline(cfg, 2, 32, seed=1)
    for _ in range(3):
        batch = next(data)
        jparams, jstate, jloss = jax_step(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, loss = step(params, state, loop.to_device(batch, "cpu"))
        assert abs(float(loss) / float(jloss) - 1) <= 1e-4
    # params are not compared leaf for leaf: Adam's first steps move an
    # entry by nearly lr whatever its gradient's size (m / sqrt(v)), so
    # float32 noise in small gradients moves entries by up to 8.7e-4 of a
    # leaf's max after 3 steps here; the losses carry the comparison
    assert int(state.step) == int(jstate.step) == 3
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(t.shape) for t in tree_leaves(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))]


def test_short_training_loss_decreases():
    cfg = get_config("qwen3-4b").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, dtype="float32")
    report = loop.train(cfg, steps=60, batch=8, seq=64, log_every=1000,
                        log_fn=lambda s: None, device="cpu")
    first, last = np.mean(report.losses[:10]), np.mean(report.losses[-10:])
    assert last < first - 0.3, (first, last)


def test_restored_run_continues_the_uninterrupted_run(tmp_path):
    cfg = get_config("zamba2-2.7b").replace(
        n_layers=2, d_model=64, ssm_head_dim=16, ssm_state=8, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, shared_attn_every=2, dtype="float32")
    kw = dict(steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=2,
              log_fn=lambda s: None, device="cpu")
    whole = loop.train(cfg, **kw)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    os.rename(tmp_path / "step_00000004", tmp_path / "step_00000004.tmp")   # cut short
    logged = []
    resumed = loop.train(cfg, **{**kw, "log_fn": logged.append})
    assert logged[0] == "restored checkpoint at step 2"
    assert resumed.losses == whole.losses[2:]


def test_launcher_trains_on_the_cpu_and_refuses_dry_run(capsys, monkeypatch):
    """The launcher trains on the CPU; ``--dry-run`` (once refused, now
    ported) hands the arch's train_4k to ``launch.dryrun.run_one`` on the
    production mesh and prints its record (the run itself:
    tests/test_torch_dryrun.py, in a process of its own)."""
    import json

    from repro_torch.launch import dryrun, mesh
    assert launch_train.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: final loss ")
    monkeypatch.setattr(mesh, "make_production_mesh", lambda **kw: "mesh")
    monkeypatch.setattr(dryrun, "run_one", lambda arch, shape, m: {
        "arch": arch, "shape": shape, "mesh": m, "status": "ok"})
    assert launch_train.main(["--dry-run", "--arch", "yi-6b"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"arch": "yi-6b", "shape": "train_4k", "mesh": "mesh", "status": "ok"}
