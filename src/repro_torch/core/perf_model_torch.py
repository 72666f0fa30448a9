"""Float64 torch twins of the batched iGniter model and budget solver.

`repro_torch.core.perf_model_vec` is the numpy hot path and stays the
pinned oracle; this module is the port's counterpart of the JAX package's
``repro.core.perf_model_jax``, one twin for each of its jitted programs:

  * ``predict_device_batch_torch``  Eqs. (1)-(11) over padded (D, N)
                                    device arrays in plain torch (the
                                    ``_eval_jit`` / `perf_model_vec._eval`
                                    twin)
  * ``budget_ms_vec_torch``         the queueing-aware SLO budget split as
                                    SOLVE_ITERS bisection halvings in
                                    plain torch (``_budget_bisect_jit`` /
                                    `queueing.budget_ms_vec` twin)
  * ``alloc_all_torch``             Algorithm 2 against every open device
                                    (``_alloc_all_jit`` /
                                    `VecCluster.alloc_all` twin): ONE
                                    launch of the CUDA kernel
                                    ``alloc_all_kernel`` on a card
                                    (`repro_torch.kernels.grant_loop`), its
                                    plain float64 torch version on the CPU;
                                    `PlannerConfig(backend="torch")` drives
                                    Alg. 1 placement through it

Decision thresholds are solved on the host, as the reference does: every
entry's ``budget_ms`` comes cached from `VecCluster` (`queueing.
BudgetModel`) and the newcomer's budget from `BudgetModel.budget_ms`, and
both travel to the device as float64, so every backend compares against
bit-identical thresholds (a 1-ulp ``log1p`` on the device could flip a
bisection branch).  The cluster state stays on the host too: a call packs
it into one float64 buffer (`pack`), copies it to the device once and the
results back once.

Numerical contract: agreement with the numpy oracle to rtol=1e-6,
atol=1e-9 (the reference's JAX contract), with decisions and grid-snapped
allocations identical.  The twins keep numpy's float operations and their
order (no fused multiply-adds: ``planner.cu`` is built with
``--fmad=false``), so they usually agree bit for bit.  float64 is
mandatory: the 1e-9 decision epsilons drown in float32 noise.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import perf_model as pm
from repro_torch.core import perf_model_vec as pmv
from repro_torch.core.queueing import RHO_MAX, SOLVE_ITERS, BudgetModel
from repro_torch.core.types import (HardwareSpec, WorkloadCoefficients,
                                    WorkloadSpec)
from repro_torch.device import resolve_device
from repro_torch.kernels import grant_loop
from repro_torch.kernels.grant_loop import true_div

F64 = torch.float64


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


# ---------------------------------------------------------------------------
# Eqs. (1)-(11)
# ---------------------------------------------------------------------------

def _eval(ca: dict, b, r, mask, hw: HardwareSpec):
    """`perf_model_vec._eval` in float64 torch: identical formula sequence."""
    k_act = (ca["k1"] * b * b + ca["k2"] * b + ca["k3"]) / (r + ca["k4"]) + ca["k5"]
    ability = torch.where(mask, b / k_act, 0.0)
    power = torch.where(mask, ca["alpha_power"] * ability + ca["beta_power"], 0.0)
    cache = torch.where(mask, ca["alpha_cacheutil"] * ability
                        + ca["beta_cacheutil"], 0.0)

    n_co = mask.sum(dim=-1).to(F64)
    ds = torch.where(n_co <= 1, 0.0, hw.alpha_sch * n_co + hw.beta_sch)   # Eq. 6
    p_demand = hw.idle_power + grant_loop.np_rowsum(power)                # Eq. 10
    freq = torch.where(p_demand <= hw.power_cap, hw.max_freq,             # Eq. 9
                       torch.clamp(hw.max_freq
                                   + hw.alpha_f * (p_demand - hw.power_cap),
                                   min=0.3 * hw.max_freq))
    slowdown = true_div(freq, hw.max_freq)

    other_cache = grant_loop.np_rowsum(cache)[..., None] - cache
    t_load = true_div(ca["d_load"] * b, hw.pcie_bw)                       # Eq. 3
    t_feedback = true_div(ca["d_feedback"] * b, hw.pcie_bw)
    t_sch = (ca["k_sch"] + ds[..., None]) * ca["n_kernels"]               # Eq. 5
    t_act = k_act * (1.0 + ca["alpha_cache"] * other_cache)               # Eq. 8
    t_gpu = (t_sch + t_act) / slowdown[..., None]                         # Eq. 4
    t_inf = t_load + t_gpu + t_feedback                                   # Eq. 1
    throughput = torch.where(mask, 1000.0 * b / (t_gpu + t_feedback), 0.0)
    return (freq, p_demand, ds, t_load, t_sch, t_act, t_gpu,
            t_feedback, t_inf, throughput)


def predict_device_batch_torch(devices: Sequence[Sequence[pm.PlacedWorkload]],
                               hw: HardwareSpec, device=None
                               ) -> pmv.BatchPrediction:
    """Drop-in for `perf_model_vec.predict_device_batch`, evaluated on
    ``device`` (None -> cuda:0); the padded arrays go over in one copy."""
    dev = resolve_device(device)
    ca, b, r, mask = pmv._pad_stack(devices)
    names = pmv.COEFF_FIELDS + ("b", "r", "mask")
    stacked = _tensor([*(getattr(ca, f) for f in pmv.COEFF_FIELDS), b, r, mask], dev)
    t = dict(zip(names, stacked))
    out = _eval(t, t["b"], t["r"], t["mask"] != 0, hw)
    (freq, p_demand, ds, t_load, t_sch, t_act, t_gpu,
     t_feedback, t_inf, throughput) = (a.cpu().numpy() for a in out)
    return pmv.BatchPrediction(
        mask=mask, freq=freq, p_demand=p_demand, delta_sch=ds,
        t_load=t_load, t_sch=t_sch, t_act=t_act, t_gpu=t_gpu,
        t_feedback=t_feedback, t_inf=t_inf, throughput=throughput)


# ---------------------------------------------------------------------------
# Queueing-aware budget split: fixed-iteration bisection
# ---------------------------------------------------------------------------

def budget_ms_vec_torch(bm: BudgetModel, slo_ms, rate_rps, batch,
                        device=None) -> np.ndarray:
    """Batched budget split on ``device`` (numpy arrays in and out): the
    same bracket, SOLVE_ITERS halvings and float operations as
    `BudgetModel.budget_ms_vec`, with the quantile factor from the host's
    ``math.log1p``, as that docstring requires."""
    dev = resolve_device(device)
    slo = _tensor(slo_ms, dev)
    if bm.mode == "half":
        return true_div(slo, 2.0).cpu().numpy()
    r_ms = true_div(_tensor(rate_rps, dev), 1000.0)
    b = _tensor(batch, dev)
    target = slo * (1.0 - bm.slack_frac)
    qf = -math.log1p(-bm.quantile)
    lo, hi = torch.zeros_like(slo), slo.clone()
    b2 = 2.0 * b
    no_arrivals = ~(r_ms > 0.0)
    acc = (b - 1.0) / r_ms
    for _ in range(SOLVE_ITERS):
        mid = 0.5 * (lo + hi)
        rho = r_ms * mid / b
        w = bm.burstiness * rho * mid / (b2 * (1.0 - rho))
        tail = torch.where(rho >= RHO_MAX, math.inf, acc + w * qf)
        tail = torch.where(no_arrivals, 0.0, tail)
        ok = mid + tail <= target
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return torch.minimum(lo, true_div(slo, 2.0)).cpu().numpy()


# ---------------------------------------------------------------------------
# Algorithm 2 over every open device
# ---------------------------------------------------------------------------

def _plane_source(cl: "pmv.VecCluster", name: str) -> np.ndarray:
    if name == "t_load":
        return cl.t_io[..., 0]
    if name == "t_feedback":
        return cl.t_io[..., 1]
    if name in pmv.COEFF_FIELDS:
        return getattr(cl.ca, name)
    return getattr(cl, name)


def pack(cl: "pmv.VecCluster", spec: WorkloadSpec,
         coeffs: WorkloadCoefficients, batch: int,
         r_lower: float) -> np.ndarray:
    """The grant loop's inputs for the cluster's d open devices, in one
    float64 buffer (`grant_loop.SCALARS`, `PLANES`, `ROWS`).  The
    newcomer's budget and static latency terms are computed here with
    the reference's own expressions."""
    hw = cl.hw
    if not hw.r_unit >= 1e-9:
        # the 1e-10 grid snap would swallow each grant: the loop never ends
        raise ValueError(f"r_unit {hw.r_unit} is below the 1e-9 grid")
    d, n = cl.d, cl.mask.shape[1]
    buf = np.empty(grant_loop.pack_size(d, n))
    ns, npl = len(grant_loop.SCALARS), len(grant_loop.PLANES)
    scalars = {
        **{f: float(getattr(coeffs, f)) for f in pmv.COEFF_FIELDS},
        "batch": float(batch), "r_lower": float(r_lower),
        "budget": cl.bm.budget_ms(spec.slo_ms, spec.rate_rps, batch),
        "t_load": coeffs.t_load(batch, hw.pcie_bw),
        "t_feedback": coeffs.t_feedback(batch, hw.pcie_bw),
        "t_schk": coeffs.k_sch * coeffs.n_kernels,
        **{f: float(getattr(hw, f)) for f in (
            "idle_power", "power_cap", "max_freq", "alpha_f", "alpha_sch",
            "beta_sch", "r_unit")}}
    buf[:ns] = [scalars[k] for k in grant_loop.SCALARS]
    planes = buf[ns:ns + npl * d * n].reshape(npl, d, n)
    for i, name in enumerate(grant_loop.PLANES):
        planes[i] = _plane_source(cl, name)[:d]
    rows = buf[ns + npl * d * n:].reshape(len(grant_loop.ROWS), d)
    rows[0] = cl.n[:d]
    rows[1] = cl.power_sum[:d]
    rows[2] = cl.cache_sum[:d]
    return buf


# Device copies per `alloc_all_torch` call: the packed inputs to the
# device, the packed outputs back.
COPIES_PER_CALL = 2


def alloc_all_torch(cl: "pmv.VecCluster", spec: WorkloadSpec,
                    coeffs: WorkloadCoefficients, batch: int, r_lower: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Backend dispatch target for `VecCluster.alloc_all` ("torch") on
    ``cl.device``: returns ``(feasible, r_res, r_new, r_inter)`` as numpy
    arrays, exactly as the numpy loop does."""
    d = cl.d
    if d == 0:
        z = np.zeros(0)
        return z.astype(bool), np.zeros((0, 1)), z, z
    n = cl.mask.shape[1]
    packed = torch.from_numpy(pack(cl, spec, coeffs, batch, r_lower)).to(cl.device)
    out = grant_loop.alloc_all(packed, d, n).cpu().numpy()
    return grant_loop.split_out(out, d, n)
