"""The port's simulator against the JAX package's: both engines of the
numpy backend byte for byte (shadows, Poisson arrivals, faults, a trace,
telemetry, a reactive controller), and the torch backend on the CPU within
the reference's JAX contract (tests/test_perf_model_jax.py:185)."""
import numpy as np
import pytest

from repro.core import provisioner as rprov
from repro.core.experiments import fitted_context as ref_fitted_context
from repro.serving import simulator as rsim
from repro.serving import telemetry as rtel
from repro.serving.workload import models as ref_models
from repro.serving.workload import specs_by_name as ref_specs_by_name
from repro.serving.workload import synthetic_workloads as ref_synthetic_workloads
from tests._torch_sim import (adjust, app_study, assert_close, assert_identical,
                              fault_schedule, port, run_both, same, spike)

from repro_torch.core import provisioner as prov
from repro_torch.core.experiments import fitted_context
from repro_torch.core.types import PlannerConfig
from repro_torch.kernels import tables
from repro_torch.serving import simulator as sim
from repro_torch.serving import telemetry
from repro_torch.serving.workload import models, specs_by_name, synthetic_workloads


@pytest.fixture(scope="module")
def app():
    return app_study()


def test_engines_match_reference_with_shadows(app):
    """Shadows (one of which activates) under Poisson arrivals, with the
    monitor timeline: the port's vec and scalar engines give the
    reference's SimResult byte for byte."""
    rctx, plan, ctx = app
    kw = dict(duration_s=4.0, shadow=True, poisson=True, seed=7, record_timeline=True)
    ref, outs = run_both(rsim, sim, plan, rctx, ctx, kw,
                         [dict(kw, engine=e, backend="numpy") for e in ("vec", "scalar")])
    for got in outs:
        assert_identical(ref, got)
    assert any(row["shadow"] for row in ref.timeline)


def test_faults_trace_telemetry_match_reference(app):
    """An outage and a straggler, a spike trace, a cluster-scope reactive
    controller and a telemetry recorder: both engines byte for byte, and
    the recorders' events (wall time excepted), timelines and event
    counters equal to the reference recorder's."""
    rctx, plan, ctx = app
    fs, tr = fault_schedule(plan), spike(6000.0)
    kw = dict(duration_s=6.0, poisson=True, seed=11, adjust_fn=adjust,
              adjust_period_s=0.9, adjust_scope="cluster", record_timeline=True)
    ref_tel = rtel.Telemetry()
    tels = {e: telemetry.Telemetry() for e in ("vec", "scalar")}
    ref, outs = run_both(rsim, sim, plan, rctx, ctx,
                         dict(kw, faults=fs, trace=tr, telemetry=ref_tel),
                         [dict(kw, faults=port(fs), trace=port(tr), telemetry=tels[e],
                               engine=e, backend="numpy") for e in tels])
    assert ref.stats["n_failures"] == 1 and ref.stats["n_reconfigs"] > 0
    want = [dict(e.to_dict(), wall_ms=0.0) for e in ref_tel.events]
    assert want
    for got, tel in zip(outs, tels.values()):
        assert_identical(ref, got)
        assert [dict(e.to_dict(), wall_ms=0.0) for e in tel.events] == want
        for ring in ("workloads", "devices", "drift"):
            assert same(getattr(tel, ring).list(), getattr(ref_tel, ring).list()), ring
        assert {k: v for k, v in tel.counters.items() if not k.startswith("dispatch_")} \
            == {k: v for k, v in ref_tel.counters.items() if not k.startswith("dispatch_")}
    assert tels["vec"].counters["dispatch_numpy"] == ref_tel.counters["dispatch_numpy"]
    assert "dispatch_scalar" in tels["scalar"].counters


def test_simulate_full_torch_cpu_matches_reference_numpy():
    """tests/test_perf_model_jax.py:185 for the port: m = 30, 3 s, the
    torch backend asked for on the CPU against the reference's numpy."""
    rctx, ctx = ref_fitted_context("tpu-v5e"), fitted_context("tpu-v5e")
    rplan = rprov.provision(ref_synthetic_workloads(30, 0), rctx.profiles, rctx.hw)
    plan = prov.provision(synthetic_workloads(30, 0), ctx.profiles, ctx.hw,
                          config=PlannerConfig(backend="numpy"))
    ref = rsim.simulate_full(rplan, ref_models(), rctx.hw, duration_s=3.0, seed=0)
    tel = telemetry.Telemetry()
    tables.launches = 0
    got = sim.simulate_full(plan, models(), ctx.hw, duration_s=3.0, seed=0,
                            device="cpu", telemetry=tel)
    specs = {s.name: s for s in synthetic_workloads(30, 0)}
    assert_close(ref, got, specs)
    assert ref.violations({s.name: s for s in ref_synthetic_workloads(30, 0)}) \
        == got.violations(specs)
    assert tel.counters["dispatch_torch"] >= 1 and "dispatch_numpy" not in tel.counters
    assert tables.launches == 0          # the CPU runs the plain version


def test_torch_cpu_shadows_faults_trace(app, monkeypatch):
    """The torch backend on the CPU in the App study with shadows, Poisson
    arrivals, the fault scenario and a spike trace: the reference's
    violations and request counts, latencies within the contract, and
    one table build per width at the start and one per shadow-activated
    device after."""
    rctx, plan, ctx = app
    fs, tr = fault_schedule(plan), spike(6000.0)
    kw = dict(duration_s=6.0, shadow=True, poisson=True, seed=3, record_timeline=True)
    calls = []
    plain = tables.tables_plain
    monkeypatch.setattr(tables, "tables_plain",
                        lambda packed, rows, n: calls.append((rows, n)) or plain(packed, rows, n))
    ref, (got,) = run_both(rsim, sim, plan, rctx, ctx, dict(kw, faults=fs, trace=tr),
                           [dict(kw, faults=port(fs), trace=port(tr), device="cpu")])
    assert_close(ref, got, specs_by_name())
    assert ref.violations(ref_specs_by_name()) == got.violations(specs_by_name())
    widths = {len(ps) for ps in port(plan).by_gpu().values()}
    flips = {row["workload"] for row in got.timeline if row["shadow"]}
    assert flips and len(got.timeline) == len(ref.timeline)
    for r, g in zip(ref.timeline, got.timeline):
        assert {k: v for k, v in g.items() if k not in ("p99_1s", "avg_1s")} == \
            {k: v for k, v in r.items() if k not in ("p99_1s", "avg_1s")}
        np.testing.assert_allclose([g["p99_1s"], g["avg_1s"]], [r["p99_1s"], r["avg_1s"]],
                                   rtol=1e-6, atol=1e-9)
    assert len(widths) < len(calls) <= len(widths) + len(flips)
