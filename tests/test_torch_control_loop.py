"""The port's closed loop against the JAX package's, over
benchmarks/dynamic_sweep.py's five scenarios at m = 100: the numpy backend
byte for byte (PlanEdit lists, admission logs, SimResults) on the
vectorized planner and simulator engines and on the scalar oracle of both;
the torch backend on the CPU with identical edits, violations and final
plans; and the forecast-on spike run of tests/test_spike_fixture.py,
reproduced by the torch backend."""
import functools
import hashlib

from tests import test_spike_fixture as fixture
from tests._torch_control import (PORT, REF, SCALAR_HORIZON_S, SCALAR_NUMPY, SCENARIOS,
                                  TORCH_CPU, VEC_NUMPY, assert_edits_close,
                                  assert_identical, controlled, plan_key, port,
                                  run_scenario, same, scenario, violations)

from repro.serving import traces as rtraces

from repro_torch.serving import telemetry


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's run of scenario ``name`` (vectorized planner and
    engine, numpy): (plan given, controller, SimResult)."""
    return run_scenario(REF, name, VEC_NUMPY)


def assert_same_run(ref, got):
    """Two closed-loop runs byte for byte: edits, admission log and
    overload counters, the SimResult, and the final plan."""
    (_, rc, rres), (_, pc, pres) = ref, got
    assert same(pc.edits, rc.edits)
    assert pc.reconciler.admission_log == rc.reconciler.admission_log
    assert pc.overload_stats() == rc.overload_stats()
    assert_identical(rres, pres)
    assert plan_key(pc.plan) == plan_key(rc.plan)


def test_scenarios_numpy_match_reference():
    """The vectorized planner (the persistent VecCluster mirror) and the
    vectorized engine on the numpy backend: every scenario byte for byte.
    no_drift does nothing and keeps its plan object; the others edit."""
    for name in SCENARIOS:
        ref = reference(name)
        got = run_scenario(PORT, name, VEC_NUMPY)
        assert_same_run(ref, got)
        plan, controller, res = got
        if name == "no_drift":
            assert controller.edits == [] and res.stats["n_reconfigs"] == 0
            assert controller.plan is plan
        else:
            assert res.stats["n_reconfigs"] > 0, name
    # overload, last: the device cap binds (growth refused, brownout)
    assert ref[2].stats["admission_capped_edits"] > 0
    assert ref[2].stats["brownout_ticks"] > 0


def test_scenarios_scalar_oracle_match_reference():
    """The scalar oracle of both: plan-in/plan-out provisioner edits and
    the event-by-event simulator engine, every scenario byte for byte
    against the reference's same configuration."""
    for name in SCENARIOS:
        kw = dict(horizon_s=SCALAR_HORIZON_S, engine="scalar")
        assert_same_run(run_scenario(REF, name, SCALAR_NUMPY, **kw),
                        run_scenario(PORT, name, SCALAR_NUMPY, **kw))


def test_scenarios_torch_cpu_match_reference():
    """The torch backend on the CPU (the grant loop's and the latency
    tables' plain float64 versions): the reference's edits (floats within
    TOL), admission log, reconfiguration count, violations and final
    plan in every scenario."""
    for name in SCENARIOS:
        _, rc, rres = reference(name)
        _, pc, pres = run_scenario(PORT, name, TORCH_CPU)
        assert_edits_close(rc.edits, pc.edits)
        assert pc.reconciler.admission_log == rc.reconciler.admission_log
        assert pc.overload_stats() == rc.overload_stats()
        assert pres.stats["n_reconfigs"] == rres.stats["n_reconfigs"], name
        assert violations(name, pres) == violations(name, rres), name
        assert plan_key(pc.plan) == plan_key(rc.plan), name


def test_forecast_spike_reproduces_fixture():
    """tests/test_spike_fixture.py's run (m = 100, 6 s, a 2.5x step at 2.4 s
    for 1.2 s, forecast on, Telemetry(retention=600)) on the port's torch
    backend: the pinned predictive-event digest and counts."""
    specs, plan, _, _, _ = scenario("no_drift")
    tr = rtraces.step_spike([s.name for s in specs], 6000.0, at_ms=2400.0,
                            duration_ms=1200.0, scale=2.5)
    tel = telemetry.Telemetry(retention=600)
    controlled(PORT, port(plan), dict(forecast=True), TORCH_CPU, duration_s=6.0,
               telemetry=tel, trace=tr, poisson=True)
    pred = [e.to_dict() for e in tel.events
            if e.kind in ("forecast", "shadow_arm", "shadow_disarm")]
    sig = "|".join(f"{e['t_s']}:{e['kind']}:{e['workload']}:{e['replicas']}"
                   for e in pred)
    assert hashlib.sha256(sig.encode()).hexdigest() == fixture.SEQUENCE_SHA256
    kinds = [e["kind"] for e in pred]
    assert kinds.count("forecast") == fixture.N_FORECAST
    assert kinds.count("shadow_arm") == fixture.N_SHADOW_ARM
    assert kinds.count("shadow_disarm") == fixture.N_SHADOW_DISARM
    assert tel.counters["reconfig_events"] == fixture.N_RECONFIGS
    assert {e["t_s"] for e in pred} == fixture.FORECAST_TICKS
