"""The simulator's physics in the port: the numpy oracle bit for bit the
reference's, the latency tables' torch twin within the reference's JAX
contract, the kernel wrapper's refusals, and the simulator's backend and
device rules (cuda:0 by default, raising without CUDA, never the CPU
unless asked for)."""
import numpy as np
import pytest

from repro.core.types import V4 as R_V4, V5E as R_V5E
from repro.serving import physics as rphysics
from repro.serving.workload import models as ref_models
from tests._torch_sim import TOL, port, same, torch

from repro_torch.core import provisioner as prov
from repro_torch.core.types import V4, V5E, PlannerConfig, WorkloadSpec
from repro_torch.kernels import tables
from repro_torch.serving import physics, physics_torch
from repro_torch.serving import simulator as sim
from repro_torch.serving.workload import models


def table_inputs(rng, n, rows=None):
    """tests/test_perf_model_jax.py:161's draws for width n."""
    R = int(rng.integers(4, 64)) if rows is None else rows
    shape = (R, n)
    args = (rng.uniform(1e6, 1e8, shape),    # d_load
            rng.uniform(1e5, 1e7, shape),    # d_fb
            rng.uniform(1e9, 1e12, shape),   # flops_i
            rng.uniform(1e7, 1e9, shape),    # w_bytes
            rng.uniform(1e5, 1e7, shape),    # a_bytes
            rng.integers(20, 400, shape).astype(float))   # n_kern
    b = rng.integers(1, 33, shape).astype(float)
    r = rng.uniform(0.05, 0.6, shape)
    return args, b, r


def test_physics_bit_identical_to_reference():
    """device_state_arrays / device_state_batch / solo_terms / device_state
    (with noise) on seeded grids, over-subscribed rows and rows past the
    bandwidth knee included."""
    rng = np.random.default_rng(0)
    descs, rdescs = list(models().values()), list(ref_models().values())
    knee = 0
    for hw, rhw in ((V5E, R_V5E), (V4, R_V4)):
        for n in (1, 2, 3, 5, 8, 9):
            args, b, r = table_inputs(rng, n)
            r = r * rng.choice([1.0, 2.5], size=(b.shape[0], 1))  # Σr past 1
            for w in (1.0, 50.0):            # weight-heavy rows cross the knee
                a = (*args[:3], args[3] * w, *args[4:])
                got = physics.device_state_arrays(*a, b, r, n, hw)
                ref = rphysics.device_state_arrays(*a, b, r, n, rhw)
                assert same(got.__dict__, ref.__dict__), (n, w)
                knee += int((ref.cache_util.sum(-1) > rphysics.BW_KNEE).sum())
            idx = rng.integers(0, len(descs), size=n)
            K = int(rng.integers(1, 9))
            bb = rng.integers(1, 33, size=(K, n)).astype(float)
            rr = rng.uniform(0.05, 0.6, size=(K, n))
            got = physics.device_state_batch([descs[i] for i in idx], bb, rr, hw)
            ref = rphysics.device_state_batch([rdescs[i] for i in idx], bb, rr, rhw)
            assert same(got.__dict__, ref.__dict__), n
            entries = [(int(i), int(x), float(y)) for i, x, y in zip(idx, bb[0], rr[0])]
            assert port(rphysics.device_state(
                [(rdescs[i], x, y) for i, x, y in entries], rhw,
                np.random.default_rng(n))) == physics.device_state(
                [(descs[i], x, y) for i, x, y in entries], hw, np.random.default_rng(n))
            for i, x, y in entries:
                assert physics.solo_terms(descs[i], x, y, hw) == \
                    rphysics.solo_terms(rdescs[i], x, y, rhw)
    assert knee > 0


def test_table_values_cpu_match_numpy():
    """The reference's test_physics_table_values_match_numpy inputs through
    physics_torch.table_values(device="cpu") and table_values_plain, and
    each width up to the kernel's capacity, over-subscribed and past the
    knee: within rtol 1e-6 / atol 1e-9 of the numpy oracle."""
    rng = np.random.default_rng(4)
    cases = [(n, *table_inputs(rng, n)) for n in (1, 2, 3, 5)]
    for n in (8, 13, tables.CAPACITY):
        args, b, r = table_inputs(rng, n)
        cases.append((n, (*args[:3], args[3] * 50.0, *args[4:]), b, r * 2.0))
    for n, args, b, r in cases:
        ref = physics.device_state_arrays(*args, b, r, n, V5E)
        want = (ref.t_load, ref.t_sched, ref.t_act, ref.t_feedback, ref.freq)
        for fn in (physics_torch.table_values, physics_torch.table_values_plain):
            got = fn(*args, b, r, n, V5E, device="cpu")
            for name, g, a in zip(tables.OUTPUTS + ("freq",), got, want):
                assert g.shape == a.shape, (n, name)
                np.testing.assert_allclose(g, a, err_msg=f"n={n} {name}", **TOL)


def test_tables_wrapper_refuses_and_counts_no_cpu_launch():
    """A width above the capacity is refused on every device (naming it), a
    packed vector of the wrong size or type is refused, and the CPU path
    counts no launch."""
    rng = np.random.default_rng(1)
    tables.launches = 0
    n = tables.CAPACITY + 1
    args, b, r = table_inputs(rng, n, rows=3)
    with pytest.raises(ValueError, match=f"n = {n} is above"):
        physics_torch.table_values(*args, b, r, n, V5E, device="cpu")
    buf, rows = physics_torch.pack(*args, b, r, n, V5E)
    with pytest.raises(ValueError, match=f"n = {n}"):
        tables.tables(torch.from_numpy(buf), rows, n)
    with pytest.raises(ValueError, match="do not pack"):
        tables.tables(torch.from_numpy(buf), rows + 1, n)
    with pytest.raises(ValueError, match="float64"):
        tables.tables(torch.from_numpy(buf).float(), rows, n)
    with pytest.raises(ValueError, match="not rows of"):
        physics_torch.pack(*args, b, r, n - 1, V5E)
    args, b, r = table_inputs(rng, 2, rows=3)
    buf, rows = physics_torch.pack(*args, b, r, 2, V5E)
    with pytest.raises(ValueError, match="unsupported device"):
        tables.tables(torch.from_numpy(buf).to("meta"), rows, 2)
    out = tables.tables(torch.from_numpy(buf), rows, 2)
    assert out.shape == (tables.out_size(rows, 2),)
    assert tables.launches == 0


def test_simulator_backend_rules(monkeypatch):
    """simulate_plan() asks for cuda:0: without CUDA it raises from
    resolve_device before any table is built on the CPU; the CPU runs only
    when asked for by name; a numpy backend with a device, the scalar
    engine with the torch backend, and the reference's "jax" are refused."""
    def no_plain(*a, **k):
        raise AssertionError("a latency table was built on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = [WorkloadSpec("W0", "qwen2-vl-7b", 300.0, 20.0)]
    from repro_torch.core.experiments import fitted_context
    ctx = fitted_context()
    plan = prov.provision(specs, ctx.profiles, ctx.hw, config=PlannerConfig(backend="numpy"))
    mods = models()
    monkeypatch.setattr(tables, "tables_plain", no_plain)
    for call in (lambda: sim.simulate_plan(plan, mods, ctx.hw, duration_s=1.0),
                 lambda: sim.simulate_full(plan, mods, ctx.hw, duration_s=1.0),
                 lambda: sim.simulate_device_sample(plan, mods, ctx.hw, duration_s=1.0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(AssertionError, match="built on the CPU"):
        sim.simulate_plan(plan, mods, ctx.hw, duration_s=1.0, device="cpu")
    for bad in (dict(backend="numpy", device="cpu"), dict(engine="scalar"),
                dict(engine="scalar", backend="torch", device="cpu"),
                dict(backend="jax"), dict(engine="cuda", backend="numpy")):
        with pytest.raises(ValueError):
            sim.simulate_plan(plan, mods, ctx.hw, duration_s=1.0, **bad)
    res = sim.simulate_plan(plan, mods, ctx.hw, duration_s=1.0, backend="numpy")
    assert res.stats["n_requests"] > 0
