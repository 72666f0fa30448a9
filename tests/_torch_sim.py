"""Shared set-up of the simulator's parity tests (tests/test_torch_sim_*.py
and tests/test_torch_simulator.py).

They hold the port's simulator (``repro_torch.serving``) and what it needs
(traces, faults, coefficients, baselines, experiments) against the JAX
package's numpy backend: the port's ``backend="numpy"`` gives the
reference's ``SimResult`` byte for byte, for both engines; its
``backend="torch"`` on the CPU (the latency tables' plain float64 torch
version) agrees within the reference's JAX contract (rtol 1e-6, atol 1e-9)
with identical violations.  They import neither
``repro.core.perf_model_jax`` nor ``repro.serving.physics_jax`` (see
``tests/_torch_planner.py``), and keep to four tests a file
(``tests/_torch_parity.py``).
"""
import copy
import dataclasses
import math

import numpy as np

from repro.core import provisioner as rprov
from repro.core.experiments import fitted_context as ref_fitted_context
from repro.serving import faults as rfaults
from repro.serving import traces as rtraces
from repro.serving.workload import models as ref_models
from repro.serving.workload import twelve_workloads as ref_twelve_workloads
from tests._torch_planner import TOL, port, torch  # noqa: F401

from repro_torch.core.experiments import fitted_context
from repro_torch.serving.workload import models

# stats that measure the host's wall clock, not the simulation
WALL_KEYS = ("wall_s", "events_per_s", "reconfig_latency_ms")
NAMES = [s.name for s in ref_twelve_workloads()]


def same(a, b) -> bool:
    """Deep equality: arrays by dtype, shape and value (NaN equal to NaN),
    dataclasses field for field, floats bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (type(a).__name__ == type(b).__name__
                and all(same(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def assert_identical(ref, got):
    """Two SimResults byte for byte: latency and wait streams, per-workload
    and per-replica metrics, the timeline, and the stats outside WALL_KEYS."""
    assert list(got.request_latencies) == list(ref.request_latencies)
    for w in ref.request_latencies:
        assert same(got.request_latencies[w], ref.request_latencies[w]), w
        assert same(got.request_waits[w], ref.request_waits[w]), w
    assert same(got.per_workload, ref.per_workload)
    assert same(got.per_replica, ref.per_replica)
    assert same(got.timeline, ref.timeline)
    strip = lambda st: {k: v for k, v in st.items() if k not in WALL_KEYS}  # noqa: E731
    assert same(strip(got.stats), strip(ref.stats))


def assert_close(ref, got, specs):
    """The torch backend's contract: the same request sets and stream
    shapes, values within TOL, identical violations."""
    assert got.violations(specs) == ref.violations(specs)
    assert list(got.request_latencies) == list(ref.request_latencies)
    for w, lat in ref.request_latencies.items():
        assert got.request_latencies[w].shape == lat.shape, w
        np.testing.assert_allclose(got.request_latencies[w], lat, err_msg=w, **TOL)
        np.testing.assert_allclose(got.request_waits[w], ref.request_waits[w],
                                   err_msg=w, **TOL)
    for k in ("n_requests", "n_passes", "n_reconfigs"):
        assert got.stats[k] == ref.stats[k], k


def app_study():
    """The 12-workload App study on the fitted tpu-v5e profiles, in both
    packages: (reference ctx, reference plan, ctx); W1's share is halved
    (as tests/test_sim_equivalence.py does) so that its shadow activates."""
    rctx = ref_fitted_context()
    plan = rprov.provision(ref_twelve_workloads(), rctx.profiles, rctx.hw)
    victim = next(p for p in plan.placements if p.workload.name == "W1")
    victim.r = max(rctx.hw.r_unit,
                   round(victim.r * 0.5 / rctx.hw.r_unit) * rctx.hw.r_unit)
    return rctx, plan, fitted_context()


def fault_schedule(plan):
    """tests/test_faults.py's scenario: one mid-run outage (W3's device)
    and one straggler (W5's), on distinct devices (reference types)."""
    g_w3 = next(p.gpu for p in plan.placements if p.workload.name == "W3")
    g_w5 = next(p.gpu for p in plan.placements if p.workload.name == "W5")
    return rfaults.merge(rfaults.FaultSchedule(down={g_w3: [[1500.0, 4000.0]]}),
                         rfaults.FaultSchedule(slow={g_w5: 2.0}))


def spike(horizon_ms):
    return rtraces.step_spike(NAMES, horizon_ms, at_ms=0.3 * horizon_ms,
                              duration_ms=0.25 * horizon_ms, scale=2.0)


def adjust(now, insts):
    """tests/test_sim_equivalence.py's instance-local reactive controller:
    grows batch under backlog, nudges r with progress."""
    for inst in insts:
        if len(inst.queue) > 2 * inst.batch and inst.batch < 32:
            inst.batch += 1
        if inst.completed > 400:
            inst.r = min(1.0, round(inst.r + 0.025, 10))


def run_both(ref_sim, sim, plan, rctx, ctx, ref_kw, kws):
    """The reference's vec engine once, then the port once per entry of
    ``kws`` (each with its own copy of the plan and ported inputs)."""
    ref = ref_sim.simulate_plan(copy.deepcopy(plan), ref_models(), rctx.hw, **ref_kw)
    outs = [sim.simulate_plan(port(copy.deepcopy(plan)), models(), ctx.hw, **kw)
            for kw in kws]
    return ref, outs
