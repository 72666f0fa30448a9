"""The port's provisioner (Theorem 1, Alg. 1/2, replica groups, the six
plan edits, type selection) against the JAX package's: plans identical,
`plan_key` for `plan_key`, with the torch backend on the CPU (the grant
loop's plain version) and with the numpy backend."""
import numpy as np
import pytest

from repro.core import provisioner as rprov
from repro.core.experiments import fitted_context as ref_fitted_context
from repro.core.types import V5E as R_V5E, WorkloadSpec as RSpec
from repro.serving.workload import twelve_workloads as ref_twelve_workloads
from tests._torch_planner import BACKENDS, port
from tests.test_perf_model import make_coeffs
from tests.test_perf_model_vec import _profiles, plan_key, random_specs

from repro_torch.core import perf_model as pm
from repro_torch.core import provisioner as prov
from repro_torch.core.fitted import fitted_context
from repro_torch.core.types import V5E
from repro_torch.serving.workload import twelve_workloads


def test_provision_plans_identical_randomized():
    """25 randomized spec sets, as tests/test_perf_model_jax.py:112 draws
    them, under both budgets."""
    rprof = _profiles()
    prof = port(rprof)
    rng = np.random.default_rng(3)
    compared = 0
    for i in range(25):
        specs = random_specs(rng)
        budget = ("queueing", "half")[i % 2]
        try:
            ref = rprov.provision(specs, rprof, R_V5E, budget=budget)
        except rprov.InfeasibleError:
            with pytest.raises(prov.InfeasibleError):
                prov.provision(port(specs), prof, V5E,
                               config=BACKENDS["numpy"].replace(budget=budget))
            continue
        for cfg in BACKENDS.values():
            got = prov.provision(port(specs), prof, V5E,
                                 config=cfg.replace(budget=budget))
            assert plan_key(got) == plan_key(ref), cfg
        compared += 1
    assert compared > 8


@pytest.mark.parametrize("budget, devices", [("queueing", 11), ("half", 6)])
def test_app_study_identical(budget, devices):
    """The 12-workload App study on the fitted tpu-v5e profiles."""
    rctx, ctx = ref_fitted_context(), fitted_context()
    ref = rprov.provision(ref_twelve_workloads(), rctx.profiles, rctx.hw,
                          budget=budget)
    assert ref.n_gpus == devices
    for cfg in BACKENDS.values():
        got = prov.provision(twelve_workloads(), ctx.profiles, ctx.hw,
                             config=cfg.replace(budget=budget))
        assert plan_key(got) == plan_key(ref), cfg
        assert prov.predicted_violations(got, ctx.profiles, ctx.hw,
                                         config=cfg.replace(budget=budget)) == \
            rprov.predicted_violations(ref, rctx.profiles, rctx.hw, budget=budget)


def test_replicate_cheapest_and_theorem1_identical():
    """replicate=True with a solo-infeasible workload split into replicas,
    provision_cheapest over tpu-v5e and tpu-v4, the joint batch mode, and
    Theorem 1 at the reference's failing Hypothesis example (slo=227.0,
    rate=5.0), compared as outputs: the property itself is not asserted."""
    rprof, prof = _profiles(), port(_profiles())
    specs = [RSpec("W0", "mid", 150.0, 40.0), RSpec("W1", "light", 200.0, 30.0),
             RSpec("W2", "heavy", 120.0, 160.0), RSpec("W3", "light", 90.0, 70.0)]
    ref = rprov.provision(specs, rprof, R_V5E, replicate=True)
    assert any("#" in p.workload.name for p in ref.placements)
    for cfg in BACKENDS.values():
        for extra in (dict(replicate=True), dict(batch="joint")):
            r = rprov.provision(specs, rprof, R_V5E, **extra)
            got = prov.provision(port(specs), prof, V5E, config=cfg.replace(**extra))
            assert plan_key(got) == plan_key(r), (cfg, extra)
    r_ctx = {hw: ref_fitted_context(hw) for hw in ("tpu-v5e", "tpu-v4")}
    ctx = {hw: fitted_context(hw) for hw in ("tpu-v5e", "tpu-v4")}
    rplan, rhw = rprov.provision_cheapest(
        ref_twelve_workloads(), {h: c.profiles for h, c in r_ctx.items()},
        [c.hw for c in r_ctx.values()], budget="half")
    for cfg in BACKENDS.values():
        plan, hw = prov.provision_cheapest(
            twelve_workloads(), {h: c.profiles for h, c in ctx.items()},
            [c.hw for c in ctx.values()], config=cfg.replace(budget="half"))
        assert (hw.name, plan_key(plan)) == (rhw.name, plan_key(rplan))
    c = make_coeffs()
    for budget in ("half", "queueing"):
        rspec = RSpec("w", "m", 227.0, 5.0)
        rb = rprov.appropriate_batch(rspec, c, R_V5E, budget=budget)
        rl = rprov.resource_lower_bound(rspec, c, R_V5E, rb, budget=budget)
        b = prov.appropriate_batch(port(rspec), port(c), V5E, budget=budget)
        assert (b, prov.resource_lower_bound(port(rspec), port(c), V5E, b,
                                             budget=budget)) == (rb, rl)
        ref_pred = rprov.pm.predict_device([rprov.pm.PlacedWorkload(c, rb, rl)], R_V5E)
        assert pm.predict_device([pm.PlacedWorkload(port(c), b, rl)], V5E) == port(ref_pred)


def test_edit_chain_identical():
    """add (with a shadow reservation), resize, migrate (with a device
    excluded), split, merge and remove, one after the other: the port's
    plan equals the reference's after every edit."""
    rprof, prof = _profiles(), port(_profiles())
    specs = [RSpec("W0", "mid", 150.0, 40.0), RSpec("W1", "light", 200.0, 30.0),
             RSpec("W2", "heavy", 300.0, 10.0), RSpec("W3", "mid", 220.0, 25.0)]
    new = RSpec("NEW", "light", 180.0, 35.0)
    for cfg in BACKENDS.values():
        ref = rprov.provision(specs, rprof, R_V5E)
        got = prov.provision(port(specs), prof, V5E, config=cfg)
        assert plan_key(got) == plan_key(ref)
        w1_gpu = next(p.gpu for p in ref.placements if p.workload.name == "W1")
        steps = [
            ("add_workload", (new,), dict(reserved={0: 0.2})),
            ("resize_workload", (RSpec("W0", "mid", 150.0, 70.0),), {}),
            ("migrate_workload", (specs[1],), dict(exclude_gpus=frozenset({w1_gpu}))),
            ("split_workload", (specs[2], 2), {}),
            ("merge_workload", (specs[2], 1), {}),
        ]
        for name, args, kw in steps:
            ref = getattr(rprov, name)(ref, args[0], *args[1:], rprof, R_V5E, **kw)
            got = getattr(prov, name)(got, port(args[0]), *args[1:], prof, V5E,
                                      config=cfg, **kw)
            assert plan_key(got) == plan_key(ref), (cfg, name)
        ref = rprov.remove_workload(ref, "NEW")
        got = prov.remove_workload(got, "NEW")
        assert plan_key(got) == plan_key(ref)
        rm = rprov.predicted_plan_metrics(ref, rprof, R_V5E)
        assert prov.predicted_plan_metrics(got, prof, V5E) == port(rm)
