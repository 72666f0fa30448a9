"""The port's control plane piece by piece against the JAX package's: the
arrival estimator bit for bit, the persistent PlanState mirror's edit
sequence, the health layer's two canary-probe runs on both simulator
engines, and the controller's device (cuda:0 unless asked otherwise, and
no CPU fallback)."""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import provisioner as rprov
from repro.serving import controller as rctl
from repro.serving import faults as rfaults
from repro.serving.workload import twelve_workloads as ref_twelve_workloads
from tests._torch_control import (PORT, REF, SCALAR_NUMPY, TORCH_CPU, VEC_NUMPY,
                                  assert_edits_close, assert_identical, contexts,
                                  controlled, estimator_trace, plan_key, port, same,
                                  torch)
from tests.test_controller import WINDOW_MS, _det_window, _poisson_window

from repro_torch.core.types import PlannerConfig
from repro_torch.serving import controller as ctl

# tests/test_forecast.py's failing Hypothesis example (ROADMAP Queue 3):
# test_linear_ramp_forecast_monotone_property at these inputs
RAMP_SLOPE, RAMP_RATE0 = 0.015625, 20.0


def estimator_cases():
    """(rate0, windows, config keywords): the windows of
    tests/test_controller.py:40-107 and tests/test_forecast.py's ramp and
    periodic series (deterministic and Poisson)."""
    det = lambda rate, k: (_det_window(rate, t0=k * WINDOW_MS), WINDOW_MS)  # noqa: E731
    rng = np.random.default_rng(0)
    yield 50.0, [det(120.0, k) for k in range(20)], {}
    yield 200.0, [(_poisson_window(rng, 200.0, t0=k * WINDOW_MS), WINDOW_MS)
                  for k in range(30)], {}
    yield 40.0, [(k * WINDOW_MS + 100.0 + np.arange(40) * 1.0, WINDOW_MS)
                 for k in range(12)], {}
    yield 3.0, [det(3.0, k) for k in range(10)], {}
    yield 80.0, ([det(80.0, 0)] + [(np.empty(0), WINDOW_MS)] * 3
                 + [det(80.0, 4)]), {}
    yield RAMP_RATE0, [det(RAMP_RATE0 * (1.0 + RAMP_SLOPE * k), k)
                       for k in range(20)], {"forecast": True}
    for period in (6, 10, 16):
        for noisy in (False, True):
            prng = np.random.default_rng(period)
            windows = []
            for k in range(64):
                rate = 100.0 * (1.0 + 0.8 * math.sin(2.0 * math.pi * k / period))
                windows.append((_poisson_window(prng, rate, t0=k * WINDOW_MS) if noisy
                                else _det_window(rate, t0=k * WINDOW_MS), WINDOW_MS))
            yield 100.0, windows, {"forecast": True}


def test_arrival_estimator_matches_reference():
    """Every output of the estimator (rate, trend, burstiness, gaps, the
    history, the projection, the noise sigma, the forecast and the
    detected period) bit for bit after every window, on deterministic,
    Poisson, spike-train, low-rate, silent, ramp and periodic input."""
    periods = set()
    for rate0, windows, cfg_kw in estimator_cases():
        ref = estimator_trace(rctl, rate0, windows, **cfg_kw)
        got = estimator_trace(ctl, rate0, windows, **cfg_kw)
        assert same(got, ref), (rate0, cfg_kw)
        periods.add(ref[-1][-1])
    # the periodic series exercise the period scan (within one tick, as
    # tests/test_forecast.py asks)
    assert all(any(p is not None and abs(p - q) <= 1 for p in periods)
               for q in (6, 10, 16)), periods


def test_planstate_edit_sequence_matches_reference():
    """tests/test_controller.py's PlanState edit sequence (resizes, a
    removal and a re-add on the App study): the port's mirror gives the
    reference's placements on the numpy backend and on the torch backend's
    plain version, and refuses a device on the numpy backend."""
    rctx, ctx = contexts()
    plan = rprov.provision(ref_twelve_workloads(), rctx.profiles, rctx.hw)
    edits = [("resize", "W5", 1.3), ("remove", "W2", None), ("resize", "W9", 0.6),
             ("resize", "W5", 1.1), ("add", "W2", 1.2), ("resize", "W11", 1.4)]
    states = {"reference": rctl.PlanState(plan, rctx.profiles, rctx.hw),
              "numpy": ctl.PlanState(port(plan), ctx.profiles, ctx.hw),
              "torch-cpu": ctl.PlanState(port(plan), ctx.profiles, ctx.hw,
                                         backend="torch", device="cpu")}
    specs = {p.workload.name: p.workload for p in plan.placements}
    for action, name, factor in edits:
        for label, state in states.items():
            if action == "remove":
                state.remove(name)
                continue
            spec = dataclasses.replace(specs[name], rate_rps=specs[name].rate_rps * factor)
            spec = spec if label == "reference" else port(spec)
            getattr(state, action)(spec, batch="eq17")
        if factor is not None:
            specs[name] = dataclasses.replace(specs[name],
                                              rate_rps=specs[name].rate_rps * factor)
    want = plan_key(states.pop("reference").to_plan())
    for label, state in states.items():
        assert plan_key(state.to_plan()) == want, label
    assert str(states["torch-cpu"].cl.device) == "cpu"
    with pytest.raises(ValueError):
        ctl.PlanState(port(plan), ctx.profiles, ctx.hw, device="cpu")


def health_runs():
    """tests/test_overload.py's two health runs on the App study (14 s,
    Poisson, health_readmit_s = 2): a permanent 2.5x straggler and an
    outage that ends, both on W3's device, in the reference's types."""
    rctx, _ = contexts()
    plan = rprov.provision(ref_twelve_workloads(), rctx.profiles, rctx.hw)
    g = next(p.gpu for p in plan.placements if p.workload.name == "W3")
    return plan, g, {"straggler": rfaults.FaultSchedule(slow={g: 2.5}),
                     "outage": rfaults.FaultSchedule(down={g: [[2000.0, 5000.0]]})}


def test_health_runs_match_reference():
    """Both health runs: byte for byte on the numpy backend with the
    vectorized planner and engine and with the scalar oracle of both; the
    same edits and quarantine on the torch backend's plain version.  The
    straggler is never readmitted, the recovered device is."""
    plan, g, schedules = health_runs()
    cfg_kw = dict(health_readmit_s=2.0)
    for kind, fs in schedules.items():
        kw = dict(duration_s=14.0, poisson=True, faults=fs)
        for planner, engine in ((VEC_NUMPY, "vec"), (SCALAR_NUMPY, "scalar")):
            rc, rres = controlled(REF, plan, cfg_kw, planner, engine=engine, **kw)
            pc, pres = controlled(PORT, port(plan), cfg_kw, planner, engine=engine, **kw)
            assert same(pc.edits, rc.edits), (kind, engine)
            assert_identical(rres, pres)
            assert pc.reconciler.quarantined == rc.reconciler.quarantined
            assert pc.health.quarantined == rc.health.quarantined
        tc, tres = controlled(PORT, port(plan), cfg_kw, TORCH_CPU, **kw)
        assert_edits_close(rc.edits, tc.edits)
        assert tc.reconciler.quarantined == rc.reconciler.quarantined
        assert tres.stats["n_failures"] == rres.stats["n_failures"]
        readmitted = any(e.action == "readmit" and e.workload == f"device:{g}"
                         for e in tc.edits)
        if kind == "straggler":
            assert g in tc.reconciler.quarantined and not readmitted
        else:
            assert g not in tc.reconciler.quarantined and readmitted


def test_controller_runs_on_cuda_unless_asked(monkeypatch):
    """Controller(plan, profiles, hw) resolves cuda:0 as it is built and
    raises without CUDA; the numpy backend and device="cpu" run anywhere;
    the scalar engine is refused on the torch backend."""
    _, ctx = contexts()
    plan, _, _ = health_runs()
    plan = port(plan)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ctl.Controller(plan, ctx.profiles, ctx.hw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ctl.Reconciler(plan, ctx.profiles, ctx.hw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ctl.Controller(plan, ctx.profiles, ctx.hw,
                       cfg=ctl.ControllerConfig(planner=PlannerConfig(batch="joint")))
    for config in (PlannerConfig(**VEC_NUMPY), PlannerConfig(**TORCH_CPU)):
        controller = ctl.Controller(plan, ctx.profiles, ctx.hw, config=config)
        assert controller.reconciler.planner == config
    with pytest.raises(ValueError, match="requires engine='vec'"):
        ctl.Controller(plan, ctx.profiles, ctx.hw,
                       config=PlannerConfig(engine="scalar", batch="joint"))
