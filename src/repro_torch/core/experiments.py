"""Shared experiment pipeline: fit -> provision -> simulate.

Used by benchmarks (one per paper table/figure) and integration tests.
Results are cached per hardware type within a process.

A copy of the JAX package's ``repro.core.experiments``.  The fit is host
numpy: `fitted_context` profiles the port's own `SimTestbed` (the numpy
ground-truth physics), so it gives the reference's coefficients bit for
bit.  `all_plans` and `evaluate_plans` take ``device``: the planners'
torch backend (`PlannerConfig`) and the simulator's run there (None ->
cuda:0, raising without CUDA; "cpu" runs the plain torch versions).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import baselines as B
from repro_torch.core import coefficients as C
from repro_torch.core import provisioner as prov
from repro_torch.core.types import (HardwareSpec, PlannerConfig,
                                    ProvisioningPlan, V4, V5E,
                                    WorkloadCoefficients, WorkloadSpec)
from repro_torch.serving.simulator import SimTestbed, measure_steady, simulate_plan
from repro_torch.serving.workload import models, specs_by_name, twelve_workloads


@dataclass
class FittedContext:
    hw: HardwareSpec
    profiles: Dict[str, WorkloadCoefficients]
    testbed: SimTestbed


@functools.lru_cache(maxsize=4)
def fitted_context(hw_name: str = "tpu-v5e") -> FittedContext:
    base = {"tpu-v5e": V5E, "tpu-v4": V4}[hw_name]
    mods = models()
    tb = SimTestbed(mods, base)
    hw = C.fit_hardware("qwen2-vl-7b", base, tb)
    tb = SimTestbed(mods, hw)
    profiles = {name: C.fit_workload(name, hw, tb) for name in mods}
    return FittedContext(hw=hw, profiles=profiles, testbed=tb)


def all_plans(ctx: Optional[FittedContext] = None, *,
              budget: str = "half", device=None
              ) -> Dict[str, ProvisioningPlan]:
    """The paper's Sec. 5.1 strategy comparison (Figs. 15-19).

    Defaults to the paper-faithful ``budget="half"`` T_slo/2 split for
    every strategy so the reproduced cost/violation orderings match the
    paper; pass ``budget="queueing"`` to compare all strategies under
    the queueing-aware split (the provisioner-wide default elsewhere).
    The planners' torch backend runs on ``device``.
    """
    ctx = ctx or fitted_context()
    specs = twelve_workloads()
    mods = models()
    mfn = functools.partial(measure_steady, models=mods, hw=ctx.hw)
    cfg = PlannerConfig(budget=budget, device=device)
    return {
        "iGniter": prov.provision(specs, ctx.profiles, ctx.hw, config=cfg),
        "FFD+": B.provision_ffd(specs, ctx.profiles, ctx.hw, config=cfg),
        "FFD++": B.provision_ffd(specs, ctx.profiles, ctx.hw,
                                 use_alloc_gpus=True, config=cfg),
        "GSLICE+": B.provision_gslice(specs, ctx.profiles, ctx.hw, mfn,
                                      config=cfg),
        "gpu-lets+": B.provision_gpulets(specs, ctx.profiles, ctx.hw,
                                         config=cfg),
    }


def evaluate_plans(plans: Dict[str, ProvisioningPlan],
                   ctx: Optional[FittedContext] = None,
                   duration_s: float = 30.0, device=None):
    """Simulate each plan for ``duration_s`` (the simulator's torch
    backend on ``device``; shadows for iGniter's)."""
    ctx = ctx or fitted_context()
    sb = specs_by_name()
    mods = models()
    out = {}
    for name, plan in plans.items():
        res = simulate_plan(plan, mods, ctx.hw, duration_s=duration_s,
                            shadow=(name == "iGniter"), device=device)
        out[name] = {
            "n_gpus": plan.n_gpus,
            "cost_per_hour": plan.cost_per_hour(),
            "violations": res.violations(sb),
            "result": res,
            "plan": plan,
        }
    return out
