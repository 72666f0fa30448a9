"""Coefficient acquisition (paper Sec. 3.1, "Obtaining Model Coefficients").

The paper fits all workload-specific coefficients from **11 solo
profiling configurations** plus a handful of co-located runs, using least
squares.  This module implements exactly that:

  * Eq. (11) surface k_act(b, r): grid-search k4, linear least squares for
    (k1, k2, k3, k5) at each candidate (the model is linear given k4).
  * p(b/k_act), c(b/k_act): 1-D linear fits.
  * alpha_cache: through-origin slope of active-time inflation vs the
    summed neighbor cache utilization (2..5 co-located runs).
  * hardware (alpha_sch, beta_sch): linear fit of the per-kernel extra
    dispatch delay vs the co-location count; alpha_f: slope of frequency
    drop vs excess power.

The profiling *testbed* is abstracted behind `ProfilingTestbed`; the
discrete-event simulator implements it (and on real hardware, Nsight-
style measurement would).

A verbatim copy of the JAX package's ``repro.core.coefficients``: the
fits are host numpy over `repro_torch.serving.simulator.SimTestbed`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.types import HardwareSpec, WorkloadCoefficients


@dataclass(frozen=True)
class ProfileSample:
    """One measured run of a workload (solo or co-located)."""
    model: str
    batch: int
    r: float
    t_load: float          # ms
    t_sched: float         # ms (total dispatch delay)
    t_act: float           # ms (active time)
    t_feedback: float      # ms
    power: float           # W (this workload's draw)
    cache_util: float      # [0,1] solo bandwidth/L2 demand
    n_kernels: int
    d_load: float          # MB at this batch
    d_feedback: float      # MB at this batch
    device_freq: float = 0.0    # MHz (co-located runs)
    device_power: float = 0.0   # W total (co-located runs)


class ProfilingTestbed(Protocol):
    def run_solo(self, model: str, batch: int, r: float) -> ProfileSample: ...
    def run_colocated(self, entries: Sequence[Tuple[str, int, float]]
                      ) -> List[ProfileSample]: ...


# The paper's 11 configurations: 5 x resource sweep, 5 x batch sweep, +1.
ELEVEN_CONFIGS: Tuple[Tuple[int, float], ...] = (
    (8, 0.2), (8, 0.4), (8, 0.6), (8, 0.8), (8, 1.0),
    (1, 0.5), (2, 0.5), (4, 0.5), (16, 0.5), (32, 0.5),
    (4, 0.3),
)


def fit_k_act(samples: Sequence[ProfileSample],
              k4_grid: np.ndarray | None = None
              ) -> Tuple[float, float, float, float, float]:
    """Fit Eq. (11) by k4 grid search + linear least squares."""
    if k4_grid is None:
        k4_grid = np.linspace(0.0, 1.0, 101)[1:]   # k4 > 0 keeps r+k4 nonzero
    b = np.array([s.batch for s in samples], dtype=np.float64)
    r = np.array([s.r for s in samples], dtype=np.float64)
    y = np.array([s.t_act for s in samples], dtype=np.float64)
    best = None
    for k4 in k4_grid:
        den = r + k4
        X = np.stack([b * b / den, b / den, 1.0 / den, np.ones_like(b)], axis=1)
        theta, *_ = np.linalg.lstsq(X, y, rcond=None)
        resid = y - X @ theta
        sse = float(resid @ resid)
        if best is None or sse < best[0]:
            best = (sse, k4, theta)
    _, k4, (k1, k2, k3, k5) = best
    return float(k1), float(k2), float(k3), float(k4), float(k5)


def _linfit(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    X = np.stack([x, np.ones_like(x)], axis=1)
    (a, b), *_ = np.linalg.lstsq(X, y, rcond=None)
    return float(a), float(b)


def fit_workload(model: str, hw: HardwareSpec, testbed: ProfilingTestbed, *,
                 configs: Sequence[Tuple[int, float]] = ELEVEN_CONFIGS,
                 partners: Sequence[Tuple[int, float]] = ((1, 0.4), (1, 0.6),
                                                          (1, 0.8), (2, 0.8)),
                 coloc_batch: int = 8, coloc_r: float = 0.2
                 ) -> WorkloadCoefficients:
    """Full lightweight acquisition for one workload on one hardware type."""
    solo = [testbed.run_solo(model, b, r) for (b, r) in configs]
    k1, k2, k3, k4, k5 = fit_k_act(solo)

    ability = np.array([s.batch / s.t_act for s in solo])
    a_p, b_p = _linfit(ability, np.array([s.power for s in solo]))
    a_c, b_c = _linfit(ability, np.array([s.cache_util for s in solo]))

    s1 = solo[0]
    d_load = s1.d_load / s1.batch
    d_feedback = s1.d_feedback / s1.batch
    k_sch = float(np.mean([s.t_sched / s.n_kernels for s in solo]))

    # alpha_cache: pair runs against an increasingly bandwidth-hungry
    # partner (paper: 2..5 concurrent launches); through-origin slope of
    # active-time inflation vs summed neighbor utilization.
    solo_ref = testbed.run_solo(model, coloc_batch, coloc_r)
    xs, ys = [], []
    for (bp_, rp) in partners:
        runs = testbed.run_colocated(
            [(model, coloc_batch, coloc_r), (model, bp_, rp)])
        me = runs[0]
        xs.append(sum(r_.cache_util for r_ in runs[1:]))
        ys.append(max(0.0, me.t_act / solo_ref.t_act - 1.0))
    xs_a, ys_a = np.array(xs), np.array(ys)
    denom = float(xs_a @ xs_a)
    alpha_cache = float(xs_a @ ys_a / denom) if denom > 0 else 0.0

    return WorkloadCoefficients(
        model=model, hardware=hw.name,
        d_load=d_load, d_feedback=d_feedback,
        n_kernels=s1.n_kernels, k_sch=k_sch,
        k1=k1, k2=k2, k3=k3, k4=k4, k5=k5,
        alpha_power=a_p, beta_power=b_p,
        alpha_cacheutil=a_c, beta_cacheutil=b_c,
        alpha_cache=alpha_cache,
    )


def fit_hardware(reference_model: str, base_hw: HardwareSpec,
                 testbed: ProfilingTestbed, *,
                 coloc_counts: Sequence[int] = (2, 3, 4, 5),
                 batch: int = 8) -> HardwareSpec:
    """Fit (alpha_sch, beta_sch, alpha_f) with one reference workload
    (paper: VGG-19, ~229 s once per GPU type)."""
    solo = testbed.run_solo(reference_model, batch, 0.2)
    k_sch = solo.t_sched / solo.n_kernels

    ns, deltas = [], []
    freq_x, freq_y = [], []
    for n in coloc_counts:
        runs = testbed.run_colocated([(reference_model, batch, 0.2)] * n)
        me = runs[0]
        deltas.append(me.t_sched / me.n_kernels - k_sch)
        ns.append(float(n))
        if me.device_power > base_hw.power_cap:
            freq_x.append(me.device_power - base_hw.power_cap)
            freq_y.append(me.device_freq - base_hw.max_freq)
    a_sch, b_sch = _linfit(np.array(ns), np.array(deltas))
    if len(freq_x) >= 2:
        alpha_f, _ = _linfit(np.array(freq_x), np.array(freq_y))
    else:
        alpha_f = base_hw.alpha_f
    return dataclasses.replace(base_hw, alpha_sch=a_sch, beta_sch=b_sch,
                               alpha_f=alpha_f)
