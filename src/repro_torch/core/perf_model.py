"""iGniter analytical DNN-inference performance model (paper Sec. 3.1).

Implements Eqs. (1)-(11) exactly:

  t_inf  = t_load + t_gpu + t_feedback                                  (1)
  h      = b / (t_gpu + t_feedback)                                     (2)
  t_load = d_load * b / B_pcie ;  t_feedback = d_feedback * b / B_pcie  (3)
  t_gpu  = (t_sch + t_act) / (f / F)                                    (4)
  t_sch  = (k_sch + Delta_sch) * n_k                                    (5)
  Delta_sch = 0 if <=1 workload else alpha_sch * n_colocated + beta_sch (6)
  t_act  = k_act * (1 + alpha_cache * sum_other c)                      (8)
  f      = F if p_demand <= P else F + alpha_f * (p_demand - P)         (9)
  p_demand = p_idle + sum_i p_i                                         (10)
  k_act  = (k1 b^2 + k2 b + k3) / (r + k4) + k5                         (11)

The module is pure Python over small lists and serves as the reference
oracle.  The provisioner calls the model O(m^2) times, which the paper
bounds at 4.61 s for m=1000 — that bound is met by the vectorized
implementation in `repro_torch.core.perf_model_vec` (the provisioner's default
engine); `tests/test_perf_model_vec.py` pins the two to <= 1e-9.
A verbatim copy of the JAX package's ``repro.core.perf_model``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.types import HardwareSpec, WorkloadCoefficients


@dataclass(frozen=True)
class PlacedWorkload:
    """A (coefficients, batch, resources) triple co-located on one device."""
    coeffs: WorkloadCoefficients
    batch: int
    r: float


@dataclass(frozen=True)
class DevicePrediction:
    """Per-device model outputs."""
    freq: float                     # f^j [MHz]
    p_demand: float                 # total power demand [W]
    delta_sch: float                # Delta_sch^j [ms/kernel]
    per_workload: Tuple["WorkloadPrediction", ...]


@dataclass(frozen=True)
class WorkloadPrediction:
    t_load: float
    t_sch: float
    t_act: float
    t_gpu: float
    t_feedback: float
    t_inf: float                    # Eq. (1)
    throughput: float               # Eq. (2) [req/s]


def delta_sch(hw: HardwareSpec, n_colocated: int) -> float:
    """Eq. (6)."""
    if n_colocated <= 1:
        return 0.0
    return hw.alpha_sch * n_colocated + hw.beta_sch


def gpu_frequency(hw: HardwareSpec, p_demand: float) -> float:
    """Eq. (9)."""
    if p_demand <= hw.power_cap:
        return hw.max_freq
    return max(hw.max_freq + hw.alpha_f * (p_demand - hw.power_cap),
               0.3 * hw.max_freq)


def predict_device(workloads: Sequence[PlacedWorkload],
                   hw: HardwareSpec) -> DevicePrediction:
    """Predict latency/throughput of every workload co-located on a device."""
    n = len(workloads)
    ds = delta_sch(hw, n)

    # Eq. (10): total power demand from solo power draws
    p_demand = hw.idle_power + sum(
        w.coeffs.power(w.batch, w.r) for w in workloads)
    f = gpu_frequency(hw, p_demand)                               # Eq. (9)
    slowdown = f / hw.max_freq

    # solo cache utilizations for Eq. (8)
    caches = [w.coeffs.cache_util(w.batch, w.r) for w in workloads]

    preds = []
    for i, w in enumerate(workloads):
        c = w.coeffs
        t_load = c.t_load(w.batch, hw.pcie_bw)                    # Eq. (3)
        t_feedback = c.t_feedback(w.batch, hw.pcie_bw)
        t_sch = (c.k_sch + ds) * c.n_kernels                      # Eq. (5)
        other_cache = sum(caches) - caches[i]
        t_act = c.k_act(w.batch, w.r) * (1.0 + c.alpha_cache * other_cache)  # Eq. (8)
        t_gpu = (t_sch + t_act) / slowdown                        # Eq. (4)
        t_inf = t_load + t_gpu + t_feedback                       # Eq. (1)
        thr = 1000.0 * w.batch / (t_gpu + t_feedback)             # Eq. (2) -> req/s
        preds.append(WorkloadPrediction(
            t_load=t_load, t_sch=t_sch, t_act=t_act, t_gpu=t_gpu,
            t_feedback=t_feedback, t_inf=t_inf, throughput=thr))
    return DevicePrediction(freq=f, p_demand=p_demand, delta_sch=ds,
                            per_workload=tuple(preds))


def predict_workload(w: PlacedWorkload, neighbors: Sequence[PlacedWorkload],
                     hw: HardwareSpec) -> WorkloadPrediction:
    """Convenience: prediction for one workload among neighbors."""
    all_w = list(neighbors) + [w]
    return predict_device(all_w, hw).per_workload[-1]
