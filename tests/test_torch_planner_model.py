"""The port's interference model, budget solver and Alg. 2 grant loop
against the JAX package's numpy oracle: the float64 torch twins on the CPU
(``repro_torch.core.perf_model_torch``; the grant loop through the plain
version of ``alloc_all_kernel``), and the port's numpy copies bit for bit.
The CUDA kernel itself is held against the same oracle on the card by
``chip_smoke.py``."""
import numpy as np

from repro.core import perf_model as rpm
from repro.core import perf_model_vec as rpmv
from repro.core import provisioner as rprov
from repro.core import queueing as rq
from repro.core.types import V5E as R_V5E, WorkloadSpec as RSpec
from tests._torch_planner import TOL, port, torch
from tests.test_perf_model_vec import _profiles, random_device

from repro_torch.core import perf_model as pm
from repro_torch.core import perf_model_torch as pmt
from repro_torch.core import perf_model_vec as pmv
from repro_torch.core import queueing as q
from repro_torch.core.types import V5E
from repro_torch.kernels import grant_loop

FIELDS = ("t_load", "t_sch", "t_act", "t_gpu", "t_feedback", "t_inf",
          "throughput", "freq", "p_demand")   # tests/test_perf_model_jax.py:19-20


def test_predict_device_batch_torch_matches_numpy():
    rng = np.random.default_rng(0)
    devices = [random_device(rng) for _ in range(16)]
    a = rpmv.predict_device_batch(devices, R_V5E)
    b = pmt.predict_device_batch_torch(port(devices), V5E, device="cpu")
    assert (a.mask == b.mask).all()
    for f in FIELDS:
        sel = a.mask if getattr(a, f).ndim == 2 else slice(None)
        np.testing.assert_allclose(getattr(b, f)[sel], getattr(a, f)[sel],
                                   err_msg=f, **TOL)


def test_budget_solver_torch_matches_numpy():
    rng = np.random.default_rng(1)
    slo = rng.uniform(40.0, 500.0, size=500)
    rate = rng.uniform(0.0, 300.0, size=500)
    rate[:5] = 0.0                                  # no arrivals: no queueing
    batch = rng.integers(1, 33, size=500).astype(float)
    for mode in ("queueing", "half"):
        ref = rq.resolve(mode).budget_ms_vec(slo, rate, batch)
        got = pmt.budget_ms_vec_torch(q.resolve(mode), slo, rate, batch,
                                      device="cpu")
        np.testing.assert_allclose(got, ref, **TOL)


def _random_clusters(rng, trials, max_residents, backend="torch"):
    """(reference cluster, port cluster on ``backend``, the newcomer's
    arguments for each), drawn as tests/test_perf_model_jax.py:68-100
    draws them; the torch backend runs on the CPU."""
    rprof = _profiles()
    prof = port(rprof)
    for _ in range(trials):
        ref = rpmv.VecCluster(R_V5E, budget="queueing")
        cl = pmv.VecCluster(V5E, budget="queueing", backend=backend,
                            device="cpu" if backend == "torch" else None)
        for d in range(int(rng.integers(1, 5))):
            ref.add_device()
            cl.add_device()
            for i in range(int(rng.integers(0, max_residents))):
                m = str(rng.choice(["light", "mid", "heavy"]))
                s = RSpec(f"R{d}_{i}", m, float(rng.uniform(80, 400)), 30.0)
                b = int(rng.integers(1, 17))
                r = float(rng.choice([0.1, 0.2, 0.25]))
                ref.add_entry(d, s, rprof[m], b, r)
                cl.add_entry(d, port(s), prof[m], b, r)
        m = str(rng.choice(["light", "mid", "heavy"]))
        s_new = RSpec("NEW", m, float(rng.uniform(80, 400)),
                      float(rng.uniform(5, 60)))
        try:
            b = rprov.appropriate_batch(s_new, rprof[m], R_V5E)
            rl = rprov.resource_lower_bound(s_new, rprof[m], R_V5E, b)
        except rprov.InfeasibleError:
            continue
        yield ref, cl, (s_new, rprof[m], b, rl), (port(s_new), prof[m], b, rl)


def test_alloc_all_plain_matches_numpy_randomized():
    """Same feasibility verdicts, the same grid points and the same Alg. 1
    scores as the numpy loop: 40 trials as the reference draws them (up to
    3 residents, N = 4) and 20 with up to 7 (N = 8, numpy's pairwise row
    sums)."""
    rng = np.random.default_rng(2)
    checked = identical = 0
    for trials, max_res in ((40, 4), (20, 8)):
        for ref, cl, rnew, new in _random_clusters(rng, trials, max_res):
            fa, rra, rna, ia = ref.alloc_all(*rnew)
            fb, rrb, rnb, ib = cl.alloc_all(*new)
            assert rrb.shape == rra.shape
            np.testing.assert_array_equal(fb, fa)
            np.testing.assert_array_equal(rrb[fa], rra[fa])
            np.testing.assert_array_equal(rnb[fa], rna[fa])
            np.testing.assert_allclose(ib[fa], ia[fa], **TOL)
            assert np.isinf(ib[~fa]).all()
            identical += all(np.array_equal(x, y) for x, y in
                             ((rra, rrb), (rna, rnb), (ia, ib)))
            checked += 1
    assert checked > 30
    # the plain version keeps numpy's operations in numpy's order
    assert identical == checked


def test_numpy_copies_bit_identical():
    """The port's numpy modules (perf_model, perf_model_vec, queueing) and
    the grant loop's numpy-order row sum give the reference's floats bit
    for bit on the same draws."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        ws = random_device(rng)
        a, b = rpm.predict_device(ws, R_V5E), pm.predict_device(port(ws), V5E)
        assert port(a) == b
    devices = [random_device(rng) for _ in range(16)]
    a = rpmv.predict_device_batch(devices, R_V5E)
    b = pmv.predict_device_batch(port(devices), V5E)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    slo = rng.uniform(40.0, 500.0, size=200)
    rate = rng.uniform(0.0, 300.0, size=200)
    batch = rng.integers(1, 33, size=200).astype(float)
    for mode in ("queueing", "half"):
        ref = rq.resolve(mode).budget_ms_vec(slo, rate, batch)
        np.testing.assert_array_equal(
            q.resolve(mode).budget_ms_vec(slo, rate, batch), ref)
        assert [q.resolve(mode).budget_ms(*x) for x in zip(slo[:20], rate, batch)] \
            == [rq.resolve(mode).budget_ms(*x) for x in zip(slo[:20], rate, batch)]
    for ref, cl, rnew, new in _random_clusters(rng, 10, 6, backend="numpy"):
        for x, y in zip(ref.alloc_all(*rnew), cl.alloc_all(*new)):
            np.testing.assert_array_equal(y, x)
    for n in (1, 3, 4, 7, 8, 9, 16, 23, 130):
        x = rng.uniform(0, 1, (50, n)) * rng.choice([1e-3, 1.0, 1e3], (50, n))
        np.testing.assert_array_equal(
            grant_loop.np_rowsum(torch.from_numpy(x)).numpy(), x.sum(axis=1))
