"""Vectorized iGniter performance model (Eqs. 1-11) over numpy arrays.

`repro_torch.core.perf_model` is the scalar reference implementation of the
paper's analytical model; Algorithm 1 calls it O(m^2) times, which the
paper bounds at 4.61 s for m = 1000 workloads.  The scalar path
recomputes every co-located workload from scratch on each +r_unit grant,
so it cannot meet that bound.  This module restructures the hot path as
array code:

  * ``CoeffArrays``          struct-of-arrays view of workload coefficients
                             (stacked k1..k5, d_load, cache/power slopes)
  * ``predict_device_vec``   all residents of ONE device in one numpy pass
  * ``predict_device_batch`` all candidate devices x all residents at once
                             (padded 2-D arrays + validity mask)
  * ``VecCluster``           mutable provisioning-time cluster state with
                             incrementally cached per-device invariants
                             (per-resident k_act / power / cache, their
                             sums, and the static t_load/t_sch parts) so a
                             +r_unit grant is O(residents touched), not a
                             full re-predict
  * ``VecCluster.alloc_all`` Algorithm 2 run for ONE newcomer against ALL
                             open devices simultaneously

Entries are replica-aware by construction: each carries its own
`WorkloadSpec`, so a replica ``w#3`` (a per-replica name with a RATE
SHARE, see `repro_torch.core.replication`) is just another entry whose cached
``budget_ms`` was solved at the share rate — the model itself never
needs to know about groups.

A copy of the JAX package's ``repro.core.perf_model_vec``, the numpy
oracle.  ``VecCluster(backend="torch")`` runs `alloc_all` through
`repro_torch.core.perf_model_torch.alloc_all_torch` on its ``device``
(the CUDA kernel ``alloc_all_kernel`` on a card, its plain float64 torch
version on the CPU); the state stays here, in numpy.

Numerical contract: every quantity matches the scalar model to <= 1e-9
(the only reordering is Python ``sum`` -> ``ndarray.sum`` for the power
and cache totals, ~1e-13 relative); `tests/test_perf_model_vec.py`
asserts this across randomized co-location mixes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perf_model as pm
from repro_torch.core.queueing import BudgetLike, QUEUEING, resolve
from repro_torch.core.types import HardwareSpec, WorkloadCoefficients, WorkloadSpec
from repro_torch.device import resolve_device

R_MAX = 1.0

# Coefficient fields stacked into arrays, in `WorkloadCoefficients` order.
COEFF_FIELDS: Tuple[str, ...] = (
    "k1", "k2", "k3", "k4", "k5", "k_sch", "n_kernels",
    "d_load", "d_feedback",
    "alpha_power", "beta_power",
    "alpha_cacheutil", "beta_cacheutil", "alpha_cache",
)

# Padding values keep every formula finite on masked slots: b=0 with
# k4=1, k5=1 gives k_act=1 and ability b/k_act = 0, hence zero power /
# cache contribution to the device sums.
_PAD = {"k4": 1.0, "k5": 1.0}


@dataclass
class CoeffArrays:
    """Struct-of-arrays over a set of workloads (any leading shape)."""
    k1: np.ndarray
    k2: np.ndarray
    k3: np.ndarray
    k4: np.ndarray
    k5: np.ndarray
    k_sch: np.ndarray
    n_kernels: np.ndarray
    d_load: np.ndarray
    d_feedback: np.ndarray
    alpha_power: np.ndarray
    beta_power: np.ndarray
    alpha_cacheutil: np.ndarray
    beta_cacheutil: np.ndarray
    alpha_cache: np.ndarray

    @classmethod
    def stack(cls, coeffs: Sequence[WorkloadCoefficients]) -> "CoeffArrays":
        return cls(**{f: np.array([getattr(c, f) for c in coeffs],
                                  dtype=np.float64)
                      for f in COEFF_FIELDS})

    def k_act(self, b: np.ndarray, r: np.ndarray) -> np.ndarray:
        """Eq. (11) on arrays."""
        return ((self.k1 * b * b + self.k2 * b + self.k3) / (r + self.k4)
                + self.k5)


# ---------------------------------------------------------------------------
# Batched forward evaluation of Eqs. (1)-(11)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchPrediction:
    """Model outputs for D devices x N resident slots (masked)."""
    mask: np.ndarray            # (D, N) bool, True = real workload
    freq: np.ndarray            # (D,)  Eq. (9)
    p_demand: np.ndarray        # (D,)  Eq. (10)
    delta_sch: np.ndarray       # (D,)  Eq. (6)
    t_load: np.ndarray          # (D, N)
    t_sch: np.ndarray
    t_act: np.ndarray
    t_gpu: np.ndarray
    t_feedback: np.ndarray
    t_inf: np.ndarray           # Eq. (1)
    throughput: np.ndarray      # Eq. (2) [req/s]

    def device(self, q: int) -> pm.DevicePrediction:
        """Materialize one device as the scalar dataclasses (drop-in)."""
        idx = np.where(self.mask[q])[0]
        per = tuple(pm.WorkloadPrediction(
            t_load=float(self.t_load[q, i]), t_sch=float(self.t_sch[q, i]),
            t_act=float(self.t_act[q, i]), t_gpu=float(self.t_gpu[q, i]),
            t_feedback=float(self.t_feedback[q, i]),
            t_inf=float(self.t_inf[q, i]),
            throughput=float(self.throughput[q, i])) for i in idx)
        return pm.DevicePrediction(
            freq=float(self.freq[q]), p_demand=float(self.p_demand[q]),
            delta_sch=float(self.delta_sch[q]), per_workload=per)


def _eval(ca: CoeffArrays, b: np.ndarray, r: np.ndarray, mask: np.ndarray,
          hw: HardwareSpec) -> BatchPrediction:
    """Evaluate Eqs. (1)-(11) for (D, N) padded device arrays."""
    k_act = ca.k_act(b, r)
    ability = np.where(mask, b / k_act, 0.0)
    power = np.where(mask, ca.alpha_power * ability + ca.beta_power, 0.0)
    cache = np.where(mask, ca.alpha_cacheutil * ability + ca.beta_cacheutil,
                     0.0)

    n_co = mask.sum(axis=-1)                                      # (D,)
    ds = np.where(n_co <= 1, 0.0, hw.alpha_sch * n_co + hw.beta_sch)  # Eq. 6
    p_demand = hw.idle_power + power.sum(axis=-1)                 # Eq. 10
    freq = np.where(p_demand <= hw.power_cap, hw.max_freq,        # Eq. 9
                    np.maximum(hw.max_freq
                               + hw.alpha_f * (p_demand - hw.power_cap),
                               0.3 * hw.max_freq))
    slowdown = freq / hw.max_freq

    other_cache = cache.sum(axis=-1)[..., None] - cache
    t_load = ca.d_load * b / hw.pcie_bw                           # Eq. 3
    t_feedback = ca.d_feedback * b / hw.pcie_bw
    t_sch = (ca.k_sch + ds[..., None]) * ca.n_kernels             # Eq. 5
    t_act = k_act * (1.0 + ca.alpha_cache * other_cache)          # Eq. 8
    t_gpu = (t_sch + t_act) / slowdown[..., None]                 # Eq. 4
    t_inf = t_load + t_gpu + t_feedback                           # Eq. 1
    with np.errstate(divide="ignore", invalid="ignore"):
        throughput = np.where(mask, 1000.0 * b / (t_gpu + t_feedback), 0.0)
    return BatchPrediction(mask=mask, freq=freq, p_demand=p_demand,
                           delta_sch=ds, t_load=t_load, t_sch=t_sch,
                           t_act=t_act, t_gpu=t_gpu, t_feedback=t_feedback,
                           t_inf=t_inf, throughput=throughput)


def _pad_stack(devices: Sequence[Sequence[pm.PlacedWorkload]]
               ) -> Tuple[CoeffArrays, np.ndarray, np.ndarray, np.ndarray]:
    """Ragged device lists -> padded (D, N) coeff/batch/r arrays + mask."""
    d = len(devices)
    n = max((len(ws) for ws in devices), default=0) or 1
    fields = {f: np.full((d, n), _PAD.get(f, 0.0)) for f in COEFF_FIELDS}
    b = np.zeros((d, n))
    r = np.ones((d, n))
    mask = np.zeros((d, n), dtype=bool)
    for q, ws in enumerate(devices):
        for i, w in enumerate(ws):
            for f in COEFF_FIELDS:
                fields[f][q, i] = getattr(w.coeffs, f)
            b[q, i] = w.batch
            r[q, i] = w.r
            mask[q, i] = True
    return CoeffArrays(**fields), b, r, mask


def predict_device_batch(devices: Sequence[Sequence[pm.PlacedWorkload]],
                         hw: HardwareSpec) -> BatchPrediction:
    """Evaluate the model for ALL candidate devices at once."""
    ca, b, r, mask = _pad_stack(devices)
    return _eval(ca, b, r, mask, hw)


def predict_device_vec(workloads: Sequence[pm.PlacedWorkload],
                       hw: HardwareSpec) -> pm.DevicePrediction:
    """Drop-in vectorized replacement for `perf_model.predict_device`."""
    return predict_device_batch([workloads], hw).device(0)


# ---------------------------------------------------------------------------
# Incremental provisioning-time cluster state
# ---------------------------------------------------------------------------

class VecCluster:
    """Padded struct-of-arrays state for every open device of one plan.

    Rows are devices, columns resident slots.  Alongside the raw
    (coeffs, batch, r) arrays it caches, per resident, the solo
    invariants the model needs at every Alg. 2 iteration —
    k_act / power / cache_util plus the r-independent t_load,
    t_feedback and k_sch*n_k — and, per device, Sigma power,
    Sigma cache and the entry count (which fixes Delta_sch).  A +r_unit
    grant therefore refreshes only the granted entries and the two sums
    (O(residents touched)) instead of re-deriving the whole device.
    """

    def __init__(self, hw: HardwareSpec, cap_d: int = 8, cap_n: int = 4,
                 budget: BudgetLike = QUEUEING, backend: str = "numpy",
                 device=None):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "numpy" and device is not None:
            raise ValueError("device= applies to backend='torch'")
        self.hw = hw
        self.backend = backend
        # the torch backend's device: None -> cuda:0, raising without CUDA
        self.device = resolve_device(device) if backend == "torch" else None
        self.bm = resolve(budget)
        self.d = 0                                  # open devices
        self._cap_d, self._cap_n = cap_d, cap_n
        self.entries: List[List[Tuple[WorkloadSpec, WorkloadCoefficients,
                                      int]]] = []
        self.ca = CoeffArrays(**{
            f: np.full((cap_d, cap_n), _PAD.get(f, 0.0))
            for f in COEFF_FIELDS})
        self.b = np.zeros((cap_d, cap_n))
        self.r = np.ones((cap_d, cap_n))
        # per-entry inference budget (T_slo/2 under budget="half", the
        # queueing-aware split otherwise) — the Alg. 2 grant threshold
        self.budget_ms = np.full((cap_d, cap_n), np.inf)
        self.mask = np.zeros((cap_d, cap_n), dtype=bool)
        self.n = np.zeros(cap_d, dtype=np.int64)
        # cached invariants
        self.k_act = np.ones((cap_d, cap_n))
        self.power = np.zeros((cap_d, cap_n))
        self.cache = np.zeros((cap_d, cap_n))
        self.t_io = np.zeros((cap_d, cap_n, 2))     # (t_load, t_feedback)
        self.t_schk = np.zeros((cap_d, cap_n))      # k_sch * n_kernels
        self.power_sum = np.zeros(cap_d)
        self.cache_sum = np.zeros(cap_d)

    # -- capacity management ------------------------------------------------

    def _grow(self, need_d: int, need_n: int) -> None:
        cap_d = max(self._cap_d, need_d)
        cap_n = max(self._cap_n, need_n)
        while self._cap_d < cap_d:
            self._cap_d *= 2
        while self._cap_n < cap_n:
            self._cap_n *= 2
        if (self._cap_d, self._cap_n) == self.mask.shape:
            return

        def grow2(a: np.ndarray, fill: float) -> np.ndarray:
            out = np.full((self._cap_d, self._cap_n) + a.shape[2:], fill,
                          dtype=a.dtype)
            out[:a.shape[0], :a.shape[1]] = a
            return out

        for f in COEFF_FIELDS:
            setattr(self.ca, f, grow2(getattr(self.ca, f), _PAD.get(f, 0.0)))
        self.b = grow2(self.b, 0.0)
        self.r = grow2(self.r, 1.0)
        self.budget_ms = grow2(self.budget_ms, np.inf)
        self.mask = grow2(self.mask, False)
        self.k_act = grow2(self.k_act, 1.0)
        self.power = grow2(self.power, 0.0)
        self.cache = grow2(self.cache, 0.0)
        self.t_io = grow2(self.t_io, 0.0)
        self.t_schk = grow2(self.t_schk, 0.0)
        for name in ("n",):
            a = getattr(self, name)
            out = np.zeros(self._cap_d, dtype=a.dtype)
            out[:a.shape[0]] = a
            setattr(self, name, out)
        for name in ("power_sum", "cache_sum"):
            a = getattr(self, name)
            out = np.zeros(self._cap_d)
            out[:a.shape[0]] = a
            setattr(self, name, out)

    # -- mutation -----------------------------------------------------------

    def add_device(self) -> int:
        self._grow(self.d + 1, 1)
        self.entries.append([])
        self.d += 1
        return self.d - 1

    def add_entry(self, q: int, spec: WorkloadSpec,
                  coeffs: WorkloadCoefficients, batch: int, r: float) -> None:
        i = int(self.n[q])
        self._grow(self.d, i + 1)
        for f in COEFF_FIELDS:
            getattr(self.ca, f)[q, i] = getattr(coeffs, f)
        self.b[q, i] = batch
        self.r[q, i] = r
        self.budget_ms[q, i] = self.bm.budget_ms(spec.slo_ms,
                                                 spec.rate_rps, batch)
        self.mask[q, i] = True
        self.n[q] = i + 1
        self.t_io[q, i, 0] = coeffs.t_load(batch, self.hw.pcie_bw)
        self.t_io[q, i, 1] = coeffs.t_feedback(batch, self.hw.pcie_bw)
        self.t_schk[q, i] = coeffs.k_sch * coeffs.n_kernels
        self.entries[q].append((spec, coeffs, batch))
        self._refresh_row(q)

    def set_row_r(self, q: int, r_row: np.ndarray) -> None:
        """Commit a new allocation vector for device q (Alg. 2 output)."""
        k = int(self.n[q])
        self.r[q, :k] = r_row[:k]
        self._refresh_row(q)

    def set_budget(self, budget: BudgetLike) -> None:
        """Swap the budget model (online burstiness update) and refresh
        every resident's cached inference budget in one vectorized
        bisection call — new entries pick the new model up via add_entry."""
        self.bm = resolve(budget)
        if self.d == 0 or not self.mask[:self.d].any():
            return
        rows, cols = np.nonzero(self.mask[:self.d])
        slo = np.array([self.entries[q][i][0].slo_ms
                        for q, i in zip(rows, cols)])
        rate = np.array([self.entries[q][i][0].rate_rps
                         for q, i in zip(rows, cols)])
        self.budget_ms[rows, cols] = self.bm.budget_ms_vec(
            slo, rate, self.b[rows, cols])

    def remove_entry(self, q: int, i: int) -> None:
        """Remove resident i from device q (workload departure /
        migration source), shifting later residents left so entry order
        — and therefore downstream plan/placement order — is preserved.
        O(residents of q): the device's cached invariants are refreshed,
        every other device is untouched."""
        k = int(self.n[q])
        if not 0 <= i < k:
            raise IndexError(f"device {q} has {k} entries, no index {i}")
        sl_from = np.s_[q, i + 1:k]
        sl_to = np.s_[q, i:k - 1]
        for f in COEFF_FIELDS:
            a = getattr(self.ca, f)
            a[sl_to] = a[sl_from]
            a[q, k - 1] = _PAD.get(f, 0.0)
        for a, fill in ((self.b, 0.0), (self.r, 1.0),
                        (self.budget_ms, np.inf), (self.k_act, 1.0),
                        (self.power, 0.0), (self.cache, 0.0),
                        (self.t_schk, 0.0)):
            a[sl_to] = a[sl_from]
            a[q, k - 1] = fill
        self.t_io[q, i:k - 1] = self.t_io[q, i + 1:k]
        self.t_io[q, k - 1] = 0.0
        self.mask[q, k - 1] = False
        self.n[q] = k - 1
        del self.entries[q][i]
        self._refresh_row(q)

    def _refresh_row(self, q: int) -> None:
        """Recompute the cached solo invariants + sums for one device."""
        k = int(self.n[q])
        if k == 0:
            self.power_sum[q] = self.cache_sum[q] = 0.0
            return
        sl = np.s_[q, :k]
        ca_row = CoeffArrays(**{f: getattr(self.ca, f)[sl]
                                for f in COEFF_FIELDS})
        k_act = ca_row.k_act(self.b[sl], self.r[sl])
        ability = self.b[sl] / k_act
        self.k_act[sl] = k_act
        self.power[sl] = ca_row.alpha_power * ability + ca_row.beta_power
        self.cache[sl] = (ca_row.alpha_cacheutil * ability
                          + ca_row.beta_cacheutil)
        self.power_sum[q] = self.power[sl].sum()
        self.cache_sum[q] = self.cache[sl].sum()

    # -- read-out -----------------------------------------------------------

    def placed(self, q: int) -> List[pm.PlacedWorkload]:
        return [pm.PlacedWorkload(coeffs=c, batch=b, r=float(self.r[q, i]))
                for i, (_, c, b) in enumerate(self.entries[q])]

    def predict(self, q: int) -> pm.DevicePrediction:
        """Full prediction of device q (fresh evaluation, one vectorized
        pass; the cached invariants are only used inside `alloc_all`)."""
        return predict_device_vec(self.placed(q), self.hw)

    def interference_snapshot(self) -> List[Dict[str, float]]:
        """Per-device interference terms straight from the cached
        invariants (no re-evaluation): entry count, Sigma-power,
        Sigma-cache, Delta_sch (Eq. 6) and the implied power demand
        (Eq. 10) — the planner-side view `repro.serving.telemetry`
        pairs with the simulator's measured timelines.  Empty devices
        are skipped (their sums are zero by construction)."""
        hw = self.hw
        out: List[Dict[str, float]] = []
        for q in range(self.d):
            n = int(self.n[q])
            if n == 0:
                continue
            out.append({
                "device": q, "n": n,
                "power_sum": float(self.power_sum[q]),
                "cache_sum": float(self.cache_sum[q]),
                "delta_sch": (0.0 if n <= 1
                              else hw.alpha_sch * n + hw.beta_sch),
                "p_demand": float(hw.idle_power + self.power_sum[q]),
            })
        return out

    # -- Algorithm 2, batched over every open device ------------------------

    def alloc_all(self, spec: WorkloadSpec, coeffs: WorkloadCoefficients,
                  batch: int, r_lower: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Try placing (spec, coeffs, batch) on EVERY open device at once.

        Returns ``(feasible, r_res, r_new, r_inter)`` where ``feasible``
        is (D,) bool, ``r_res`` the (D, N) post-Alg.2 resident
        allocations, ``r_new`` the (D,) newcomer allocation and
        ``r_inter`` the (D,) interference-induced extra resources
        (Alg. 1 line 8 score; +inf where infeasible).

        Per-device trajectories are identical to the scalar
        `provisioner.alloc_gpus`: each iteration grants +r_unit to every
        resident or newcomer whose predicted t_inf exceeds T_slo/2, a
        device leaves the loop when it converges or exceeds r_max.

        With ``backend="torch"`` the loop runs as
        `perf_model_torch.alloc_all_torch` on ``self.device`` instead
        (identical decisions and grid points, floats within 1e-6).
        """
        hw = self.hw
        d = self.d
        if d == 0:
            z = np.zeros(0)
            return z.astype(bool), np.zeros((0, 1)), z, z
        if self.backend == "torch":
            from repro_torch.core import perf_model_torch
            return perf_model_torch.alloc_all_torch(self, spec, coeffs,
                                                    batch, r_lower)
        ncap = self.mask.shape[1]
        mask = self.mask[:d]

        # trial copies of the mutable state (residents) + newcomer columns
        rr = self.r[:d].copy()
        ka = self.k_act[:d].copy()
        pw = self.power[:d].copy()
        cu = self.cache[:d].copy()
        rn = np.full(d, r_lower)
        bn = float(batch)

        def solo_new(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
            k_act = ((coeffs.k1 * bn * bn + coeffs.k2 * bn + coeffs.k3)
                     / (rn[rows] + coeffs.k4) + coeffs.k5)
            ability = bn / k_act
            return (k_act,
                    coeffs.alpha_power * ability + coeffs.beta_power,
                    coeffs.alpha_cacheutil * ability + coeffs.beta_cacheutil)

        all_rows = np.arange(d)
        kan = np.empty(d)
        pn = np.empty(d)
        cn = np.empty(d)
        kan[:], pn[:], cn[:] = solo_new(all_rows)

        p_sum = self.power_sum[:d] + pn
        c_sum = self.cache_sum[:d] + cn
        n_co = self.n[:d] + 1
        ds = np.where(n_co <= 1, 0.0,
                      hw.alpha_sch * n_co + hw.beta_sch)        # Eq. 6
        budget_new = self.bm.budget_ms(spec.slo_ms, spec.rate_rps, batch)
        t_load_new = coeffs.t_load(batch, hw.pcie_bw)
        t_fb_new = coeffs.t_feedback(batch, hw.pcie_bw)
        t_schk_new = coeffs.k_sch * coeffs.n_kernels

        active = np.ones(d, dtype=bool)
        feasible = np.ones(d, dtype=bool)
        while True:
            # loop-top capacity check (scalar: `while sum(r_a) <= R_MAX`)
            tot = np.where(mask, rr, 0.0).sum(axis=1) + rn
            over = active & (tot > R_MAX + 1e-9)
            feasible[over] = False
            active[over] = False
            idx = np.where(active)[0]
            if idx.size == 0:
                break

            # model evaluation from cached invariants (active rows only)
            p_dem = hw.idle_power + p_sum[idx]                  # Eq. 10
            freq = np.where(p_dem <= hw.power_cap, hw.max_freq,  # Eq. 9
                            np.maximum(hw.max_freq + hw.alpha_f
                                       * (p_dem - hw.power_cap),
                                       0.3 * hw.max_freq))
            slow = freq / hw.max_freq
            m_i = mask[idx]
            other_res = c_sum[idx][:, None] - cu[idx]
            t_act = ka[idx] * (1.0 + self.ca.alpha_cache[idx] * other_res)
            t_sch = self.t_schk[idx] + ds[idx][:, None] * self.ca.n_kernels[idx]
            t_gpu = (t_sch + t_act) / slow[:, None]
            t_inf = self.t_io[idx, :, 0] + t_gpu + self.t_io[idx, :, 1]
            viol_res = m_i & (t_inf > self.budget_ms[idx] + 1e-9)

            other_new = c_sum[idx] - cn[idx]
            t_act_n = kan[idx] * (1.0 + coeffs.alpha_cache * other_new)
            t_gpu_n = (t_schk_new + ds[idx] * coeffs.n_kernels + t_act_n) / slow
            t_inf_n = t_load_new + t_gpu_n + t_fb_new
            viol_new = t_inf_n > budget_new + 1e-9

            conv = ~viol_res.any(axis=1) & ~viol_new
            active[idx[conv]] = False
            if not (viol_res[~conv].any() or viol_new[~conv].any()):
                continue

            # grants: +r_unit to every violator on still-active devices
            grow = np.zeros((d, ncap), dtype=bool)
            grow[idx] = viol_res & ~conv[:, None]
            if grow.any():
                rows, cols = np.nonzero(grow)
                rr[rows, cols] = np.round(rr[rows, cols] + hw.r_unit, 10)
                ca_g = CoeffArrays(**{f: getattr(self.ca, f)[rows, cols]
                                      for f in COEFF_FIELDS})
                k_act = ca_g.k_act(self.b[rows, cols], rr[rows, cols])
                ability = self.b[rows, cols] / k_act
                p_new = ca_g.alpha_power * ability + ca_g.beta_power
                c_new = ca_g.alpha_cacheutil * ability + ca_g.beta_cacheutil
                np.subtract.at(p_sum, rows, pw[rows, cols] - p_new)
                np.subtract.at(c_sum, rows, cu[rows, cols] - c_new)
                ka[rows, cols] = k_act
                pw[rows, cols] = p_new
                cu[rows, cols] = c_new
            grow_n = np.zeros(d, dtype=bool)
            grow_n[idx] = viol_new & ~conv
            if grow_n.any():
                rows = np.where(grow_n)[0]
                rn[rows] = np.round(rn[rows] + hw.r_unit, 10)
                k_act, p_new, c_new = solo_new(rows)
                p_sum[rows] += p_new - pn[rows]
                c_sum[rows] += c_new - cn[rows]
                kan[rows], pn[rows], cn[rows] = k_act, p_new, c_new

        # Alg. 1 line 8: extra resources caused by interference
        grown = np.where(mask, np.maximum(0.0, rr - self.r[:d]), 0.0)
        r_inter = grown.sum(axis=1) + np.maximum(0.0, rn - r_lower)
        r_inter = np.where(feasible, r_inter, np.inf)
        return feasible, rr, rn, r_inter


def alloc_gpus_vec(residents: Sequence[Tuple[WorkloadSpec,
                                             WorkloadCoefficients,
                                             int, float]],
                   spec: WorkloadSpec, coeffs: WorkloadCoefficients,
                   batch: int, r_lower: float,
                   hw: HardwareSpec, *,
                   budget: BudgetLike = QUEUEING,
                   backend: str = "numpy",
                   device=None) -> Optional[List[float]]:
    """Single-device convenience wrapper matching `provisioner.alloc_gpus`
    (same signature semantics: returns the new allocation vector with the
    newcomer last, or None when the device cannot host it)."""
    cl = VecCluster(hw, budget=budget, backend=backend, device=device)
    q = cl.add_device()
    for (s, c, b, r) in residents:
        cl.add_entry(q, s, c, b, r)
    feasible, rr, rn, _ = cl.alloc_all(spec, coeffs, batch, r_lower)
    if not bool(feasible[0]):
        return None
    k = int(cl.n[q])
    return [float(x) for x in rr[0, :k]] + [float(rn[0])]
