"""Shared set-up of the controller's parity tests (tests/test_torch_controller.py
and tests/test_torch_control_loop.py).

They hold the port's control plane (``repro_torch.serving.controller``)
against the JAX package's: the reference side always runs its numpy
backend; the port's ``backend="numpy"`` gives the reference's `PlanEdit`
lists, admission logs and `SimResult`s byte for byte, and its
``backend="torch"`` on the CPU (the grant loop's and the latency tables'
plain float64 torch versions) gives identical edits (floats within
``TOL``), violations and final plans.  The scenarios are
``benchmarks/dynamic_sweep.py``'s, built with its own helpers on the
reference side and carried over to the port's types with
``tests._torch_planner.port``.  Like the other parity tests these import
neither ``repro.core.perf_model_jax`` nor ``repro.serving.physics_jax``.
"""
import dataclasses
import functools

import numpy as np

from benchmarks import dynamic_sweep as sweep
from repro.core import provisioner as rprov
from repro.core.experiments import fitted_context as ref_fitted_context
from repro.core.types import PlannerConfig as RPlannerConfig
from repro.serving import controller as rctl
from repro.serving import simulator as rsim
from repro.serving.workload import models as ref_models
from repro.serving.workload import synthetic_workloads as ref_synthetic_workloads
from tests._torch_planner import TOL, port, torch  # noqa: F401
from tests._torch_sim import assert_identical, same  # noqa: F401
from tests.test_perf_model_vec import plan_key  # noqa: F401

from repro_torch.core.experiments import fitted_context
from repro_torch.core.types import PlannerConfig
from repro_torch.serving import controller as ctl
from repro_torch.serving import simulator as sim
from repro_torch.serving.workload import models

M, SEED = 100, 0                      # dynamic_sweep's m = 100 cell
HORIZON_S = 4.0                       # four control ticks (the sweep runs 10)
SCALAR_HORIZON_S = 2.0                # the scalar engine steps event by event
SCENARIOS = sweep.SCENARIOS           # no_drift, diurnal, spike, churn, overload
REF = (rctl, rsim, ref_models)
PORT = (ctl, sim, models)
# the planner configurations of a controlled run: the vectorized engine on
# each backend, and the scalar engine (plan-in/plan-out provisioner ops),
# the oracle, which runs on numpy only
VEC_NUMPY = dict(backend="numpy", batch="joint")
SCALAR_NUMPY = dict(engine="scalar", backend="numpy", batch="joint")
TORCH_CPU = dict(backend="torch", device="cpu", batch="joint")


@functools.lru_cache(maxsize=None)
def contexts():
    """The fitted tpu-v5e context in both packages: (reference, port)."""
    return ref_fitted_context("tpu-v5e"), fitted_context("tpu-v5e")


@functools.lru_cache(maxsize=None)
def scenario(name, horizon_s=HORIZON_S):
    """dynamic_sweep's scenario ``name`` at m = 100 on tpu-v5e over
    ``horizon_s``, in the reference's types: (specs, plan, trace, poisson,
    controller-config keywords).  The plan is the numpy oracle's (the
    overload fleet through the sweep's ``_overload_plan``, which the
    controller may not grow past)."""
    rctx, _ = contexts()
    specs = ref_synthetic_workloads(M, SEED)
    cfg = RPlannerConfig(backend="numpy")
    plan = rprov.provision(specs, rctx.profiles, rctx.hw, config=cfg)
    cfg_kw = {}
    if name == "overload":
        specs = sweep._overload_specs(specs)
        plan, _ = sweep._overload_plan(specs, {rctx.hw.name: rctx.profiles},
                                       [rctx.hw], cfg)
        cfg_kw = dict(max_devices=plan.n_gpus, headroom=0.35)
    tr, poisson = sweep._make_trace(name, [s.name for s in specs],
                                    horizon_s * 1000.0, SEED)
    return specs, plan, tr, poisson, cfg_kw


def controlled(side, plan, cfg_kw, planner, *, engine="vec",
               duration_s=HORIZON_S, telemetry=None, **sim_kw):
    """One closed-loop run of ``side`` (REF or PORT) over ``plan`` (of that
    side's types, as ``telemetry`` is), with a fresh controller:
    (controller, SimResult).  The port's other simulator inputs (trace,
    faults) are carried over from the reference's; its simulator's backend
    follows the planner's (numpy, or torch on its device)."""
    mod, simulator, mods = side
    rctx, ctx = contexts()
    if side is PORT:
        sim_kw = {k: port(v) for k, v in sim_kw.items()}
        sim_kw.update(backend=planner["backend"], device=planner.get("device"))
        c, config = ctx, PlannerConfig(**planner)
    else:
        c, config = rctx, RPlannerConfig(**planner)
    controller = mod.Controller(plan, c.profiles, c.hw, config=config,
                                cfg=mod.ControllerConfig(**cfg_kw),
                                telemetry=telemetry)
    res = simulator.simulate_plan(plan, mods(), c.hw, duration_s=duration_s,
                                  seed=SEED, adjust_fn=controller,
                                  adjust_scope="cluster", adjust_period_s=1.0,
                                  engine=engine, telemetry=telemetry, **sim_kw)
    return controller, res


def run_scenario(side, name, planner, *, horizon_s=HORIZON_S, engine="vec"):
    """``controlled`` over scenario ``name``: (plan given, controller,
    SimResult)."""
    _, plan, tr, poisson, cfg_kw = scenario(name, horizon_s)
    plan = port(plan) if side is PORT else plan
    controller, res = controlled(side, plan, cfg_kw, planner, engine=engine,
                                 duration_s=horizon_s, trace=tr, poisson=poisson)
    return plan, controller, res


def violations(name, res, horizon_s=HORIZON_S):
    """The run's violations against dynamic_sweep's trace-scaled specs (its
    ``_scaled_specs``: judged against what the trace offered)."""
    specs, _, tr, _, _ = scenario(name, horizon_s)
    return res.violations(sweep._scaled_specs(specs, tr, horizon_s * 1000.0))


def assert_edits_close(ref, got):
    """Two PlanEdit lists field for field: strings and counts equal, floats
    within TOL (the torch backend's contract)."""
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert type(b).__name__ == type(a).__name__
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, float):
                np.testing.assert_allclose(y, x, err_msg=f"{a} {f.name}", **TOL)
            else:
                assert x == y, (a, b, f.name)


def estimator_trace(mod, rate0, windows, horizon=3.0, **cfg_kw):
    """Everything an ArrivalEstimator of ``mod`` exposes after each window
    of ``windows`` (a list of (arrivals, window_ms)): its state, the
    projected rate, the rate's sigma, the forecast and the period."""
    est = mod.ArrivalEstimator(rate0, mod.ControllerConfig(**cfg_kw))
    out = []
    for arrivals, window_ms in windows:
        est.observe(arrivals, window_ms)
        out.append((est.rate_rps, est.trend_rps, est.cv2, est.n_windows, est.n_gaps,
                    est.ever_active, est.empty_ms, est._g1, est._g2, list(est._gap_buf),
                    list(est.history), est.projected_rps, est.rate_sigma(),
                    est.forecast_rps(horizon), est.detect_period()))
    return out
