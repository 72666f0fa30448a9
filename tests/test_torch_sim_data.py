"""What the simulator is fed and what feeds on it, in the port: traces and
fault schedules draw for draw the reference's, the coefficient fits on the
reference's testbed samples, and the Sec. 5.1 strategy comparison
(`all_plans` / `evaluate_plans`) with the planners' and the simulator's
torch backend on the CPU."""
import numpy as np
import pytest

from repro.core import coefficients as rcoeff
from repro.core import experiments as rexp
from repro.serving import faults as rfaults
from repro.serving import traces as rtraces
from repro.serving.workload import models as ref_models
from tests._torch_sim import NAMES, port, same
from tests.test_perf_model_vec import plan_key

from repro_torch.core import coefficients as coeff
from repro_torch.core import experiments as exp
from repro_torch.serving import faults, traces
from repro_torch.serving.simulator import SimTestbed


def test_traces_and_faults_draw_for_draw():
    """Every generator of both modules, and the arrivals drawn over a trace
    from the same numpy streams, equal to the reference's."""
    kw_tr = [("constant", (NAMES, 5000.0), dict(scale=1.5)),
             ("diurnal", (NAMES, 5000.0), dict(peak=1.8, phase=0.1)),
             ("step_spike", (NAMES, 5000.0), dict(at_ms=1200.0, duration_ms=900.0, scale=2.5)),
             ("churn", (NAMES, 5000.0), dict(departures={"W2": 1800.0},
                                             arrivals={"W7": 2200.0})),
             ("random_churn", (NAMES, 5000.0), dict(depart_frac=0.2, seed=3))]
    for name, args, kw in kw_tr:
        ref, got = getattr(rtraces, name)(*args, **kw), getattr(traces, name)(*args, **kw)
        assert same(got, port(ref)) and same(port(ref), got), name
        for i, w in enumerate(("W2", "W7")):
            for poisson in (False, True):
                e, s = ref.segments(w, 6000.0)
                a = rtraces.gen_arrivals(40.0, e, s, 6000.0, poisson,
                                         np.random.default_rng([5, i, 0]))
                b = traces.gen_arrivals(40.0, *got.segments(w, 6000.0), 6000.0, poisson,
                                        np.random.default_rng([5, i, 0]))
                assert same(a, b), (name, w, poisson)
        assert got.mean_scale("W2", 6000.0) == ref.mean_scale("W2", 6000.0)
    kw_f = [("random_failures", (40, 20000.0), dict(rate_per_min=1.5, mttr_ms=700.0, seed=2)),
            ("stragglers", (40,), dict(frac=0.2, multiplier=1.7, seed=4))]
    got_f, ref_f = [], []
    for name, args, kw in kw_f:
        ref_f.append(getattr(rfaults, name)(*args, **kw))
        got_f.append(getattr(faults, name)(*args, **kw))
        assert same(got_f[-1], port(ref_f[-1])), name
    merged = faults.merge(*got_f)
    assert same(merged, port(rfaults.merge(*ref_f)))
    assert merged.down and merged.slow
    assert same(list(merged.boundaries()), list(rfaults.merge(*ref_f).boundaries()))


def test_coefficient_fits_equal_reference():
    """The port's SimTestbed gives the reference's profile samples, and the
    port's fits on the reference's testbed samples give the reference's
    coefficients, for every served model on both hardware types."""
    for hw_name in ("tpu-v5e", "tpu-v4"):
        rctx = rexp.fitted_context(hw_name)
        rtb, tb = rctx.testbed, SimTestbed(exp.models(), port(rctx.hw))
        for name in ref_models():
            for b, r in rcoeff.ELEVEN_CONFIGS:
                assert tb.run_solo(name, b, r) == port(rtb.run_solo(name, b, r))
            assert tb.run_colocated([(name, 8, 0.2), (name, 2, 0.8)]) == \
                port(rtb.run_colocated([(name, 8, 0.2), (name, 2, 0.8)]))
            got = coeff.fit_workload(name, port(rctx.hw), rtb)
            assert got == port(rcoeff.fit_workload(name, rctx.hw, rtb)), name
            samples = [rtb.run_solo(name, b, r) for b, r in rcoeff.ELEVEN_CONFIGS]
            assert coeff.fit_k_act(samples) == rcoeff.fit_k_act(samples)
            assert coeff.fit_k_act(port(samples)) == rcoeff.fit_k_act(samples)
        base = {"tpu-v5e": rexp.V5E, "tpu-v4": rexp.V4}[hw_name]
        assert coeff.fit_hardware("qwen2-vl-7b", port(base), rtb) == \
            port(rcoeff.fit_hardware("qwen2-vl-7b", base, rtb))


@pytest.fixture(scope="module")
def plans():
    """{budget: (reference plans, the port's plans)}; the port's torch
    backend runs on the CPU, asked for by name."""
    return {b: (rexp.all_plans(budget=b), exp.all_plans(budget=b, device="cpu"))
            for b in ("half", "queueing")}


def test_all_plans_match_reference(plans):
    """The five strategies, plan_key for plan_key, under both budgets."""
    for budget, (ref, got) in plans.items():
        assert list(got) == list(ref) == ["iGniter", "FFD+", "FFD++", "GSLICE+", "gpu-lets+"]
        for name in ref:
            assert plan_key(got[name]) == plan_key(ref[name]), (budget, name)


def test_evaluate_plans_match_reference(plans):
    """evaluate_plans with the simulator's torch backend on the CPU gives
    the reference's violations, device counts, costs and request counts."""
    ref, got = plans["half"]
    r_ev = rexp.evaluate_plans(ref, duration_s=5.0)
    g_ev = exp.evaluate_plans(got, duration_s=5.0, device="cpu")
    for name in ref:
        for key in ("n_gpus", "cost_per_hour", "violations"):
            assert g_ev[name][key] == r_ev[name][key], (name, key)
        assert g_ev[name]["result"].stats["n_requests"] == \
            r_ev[name]["result"].stats["n_requests"], name
    assert not g_ev["iGniter"]["violations"]       # the paper's Sec. 5.1 ordering
