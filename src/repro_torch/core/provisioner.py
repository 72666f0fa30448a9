"""iGniter GPU resource provisioning strategy (paper Sec. 4.1).

Implements Theorem 1 (appropriate batch size b_appr, Eq. 17; resource
lower bound r_lower, Eq. 18), Algorithm 2 (`alloc_gpus`) and Algorithm 1
(`provision`) faithfully, including the ANYFIT new-device rule and the
greedy minimum-interference device selection.

Two interchangeable engines drive the algorithms:

  * ``engine="vec"`` (default): the vectorized/batched performance model
    from `repro_torch.core.perf_model_vec` — Alg. 2 scores ALL open devices in
    one call per placement with incrementally cached device invariants.
    This is the path that meets the paper's m=1000-in-seconds bound
    (Sec. 5.4); `benchmarks/scale_sweep.py` tracks it.
  * ``engine="scalar"``: the original pure-Python reference, kept as the
    cross-check oracle (`tests/test_perf_model_vec.py` asserts both
    engines emit identical plans).

A copy of the JAX package's ``repro.core.provisioner``.  The vectorized
engine's backend is "torch" by default: `VecCluster.alloc_all` then runs
the Alg. 2 grant loop as one CUDA kernel launch per call on the card
(``PlannerConfig.device``; its plain float64 torch version on the CPU),
with plans identical to ``backend="numpy"``.
"""
from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perf_model as pm
from repro_torch.core import perf_model_vec as pmv
from repro_torch.core import replication
from repro_torch.core.queueing import BudgetLike, BudgetModel, QUEUEING, resolve
from repro_torch.core.types import (HardwareSpec, K_MAX, Placement, PlannerConfig,
                              ProvisioningPlan, WorkloadCoefficients,
                              WorkloadSpec, planner_config)

R_MAX = 1.0
# Replica-count ceiling (`required_replicas`) — canonical home is
# `types.K_MAX`; re-exported here for backward compatibility.


class InfeasibleError(RuntimeError):
    """A workload cannot meet its SLO even alone on a full device.

    When raised by `provision_cheapest`, ``per_hw`` maps each hardware
    name to the error string of the workload that made that type
    infeasible — structured diagnostics instead of one joined string,
    so m=10k infeasibility reports stay actionable."""

    def __init__(self, message: str = "", *,
                 per_hw: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.per_hw: Dict[str, str] = dict(per_hw) if per_hw else {}


class DeviceCapError(InfeasibleError):
    """The ``max_devices`` fleet cap binds: the workload is physically
    feasible but placing it would open a device beyond the budget.

    Distinct from a Theorem-1 infeasibility — capacity exists in
    principle, the fleet just may not grow — so the controller's
    admission layer can react with shed / brownout / preemption instead
    of reporting a physics error.  Always carries ``per_hw``."""


# ---------------------------------------------------------------------------
# Theorem 1
# ---------------------------------------------------------------------------

def appropriate_batch(spec: WorkloadSpec, c: WorkloadCoefficients,
                      hw: HardwareSpec, *, b_max: int = 64,
                      budget: BudgetLike = QUEUEING,
                      batch: str = "eq17") -> int:
    """Eq. (17): smallest batch sustaining the arrival rate within T_slo/2.

    R is req/s; the model works in ms, so R_ms = R / 1000.

    ``batch="eq17"`` (default): the paper's closed-form batch.  The
    batch choice is shared by both budget modes (the queueing-aware
    split reallocates T_slo between waiting and service AT this batch,
    which is what keeps its allocations never looser than the paper's
    half split).  Under ``budget="queueing"`` the batch is additionally
    shrunk — in practice a no-op safety net — while the solved inference
    budget at b is degenerate (<= 0), which can only happen when the
    accumulation tail (b-1)/R_ms eats the whole SLO.

    ``batch="joint"`` (opt-in, beyond-paper): re-optimize b JOINTLY with
    the bisection-solved budget — scan every stable candidate b (batch
    interval b/R_ms covering the solved inference budget B(b), i.e. the
    steady-state condition behind Eq. 17) and keep Eq. 17's b unless
    some candidate's Theorem-1 solo lower bound r_lower is STRICTLY
    smaller (tie-break: smaller batch, less accumulation wait).  Eq. 17
    maximizes b for the fixed half split; with a b-dependent budget a
    smaller batch can trade accumulation slack for service budget and
    shave whole r_units off the lower bound — never-worse by
    construction since Eq. 17's b stays in the candidate set.
    """
    r_ms = spec.rate_rps / 1000.0
    num = spec.slo_ms * r_ms * hw.pcie_bw
    den = 2.0 * (hw.pcie_bw + r_ms * c.d_load)
    b = int(math.ceil(num / den))
    b = max(1, min(b, b_max))
    bm = resolve(budget)
    if bm.mode != "half":
        while b > 1 and bm.budget_ms(spec.slo_ms, spec.rate_rps, b) <= 1e-6:
            b -= 1
    if batch == "eq17":
        return b
    if batch != "joint":
        raise ValueError(f"unknown batch mode {batch!r} "
                         "(expected 'eq17' or 'joint')")

    # One vectorized bisection solves every candidate's budget at once —
    # bitwise-identical to the scalar solver (see `budget_ms_vec`), so
    # the candidate ranking cannot drift from the scalar path.  The
    # controller re-runs this scan on every edit at ever-fresh estimated
    # rates, where 64 scalar bisections per probe dominated the edit
    # overhead.
    bs = np.arange(1, b_max + 1, dtype=np.float64)
    Bs = bm.budget_ms_vec(np.full(b_max, spec.slo_ms),
                          np.full(b_max, spec.rate_rps), bs)

    def _r_lower_at(bb: int) -> Optional[float]:
        B = float(Bs[bb - 1])
        if B <= 1e-6 or (r_ms > 0.0 and bb / r_ms < B - 1e-9):
            return None          # degenerate budget / unstable at B
        try:
            return resource_lower_bound(spec, c, hw, bb, budget=bm,
                                        solved_budget_ms=B)
        except InfeasibleError:
            return None
    best_b, best_r = b, _r_lower_at(b)
    for bb in range(1, b_max + 1):   # ascending: ties keep the smaller b
        if bb == b:
            continue
        r = _r_lower_at(bb)
        if r is None:
            continue
        if best_r is None or r < best_r - 1e-12:
            best_b, best_r = bb, r
        elif (r >= R_MAX - 1e-12 and best_r >= R_MAX - 1e-12
              and bb > best_b):
            # every candidate clamps to a full device: the budget is out
            # of reach either way, so take the batch with the most
            # throughput (largest b) to minimize the rate shortfall
            best_b = bb
    # best_r None: no candidate is feasible — return Eq. 17's b so the
    # caller raises/clamps exactly as it would without joint mode
    return best_b


def resource_lower_bound(spec: WorkloadSpec, c: WorkloadCoefficients,
                         hw: HardwareSpec, b_appr: Optional[int] = None, *,
                         budget: BudgetLike = QUEUEING,
                         solved_budget_ms: Optional[float] = None) -> float:
    """Eq. (18): minimal solo resource fraction meeting the inference
    budget (T_slo/2 under ``budget="half"``, the queueing-aware split
    otherwise).

    Under the queueing budget, a workload whose TIGHTENED budget is out
    of reach even on a full device is clamped to R_MAX (the honest
    residual then surfaces in `predicted_violations`, mirroring the
    `self_grant` fallback); a workload infeasible even at the paper's
    half split still raises InfeasibleError in both modes.

    ``solved_budget_ms`` lets a caller that already solved the budget at
    ``b_appr`` (e.g. the joint-batch scan's vectorized bisection) skip
    re-solving it; it must equal ``budget.budget_ms(slo, rate, b_appr)``
    bit-for-bit.
    """
    bm = resolve(budget)
    b = b_appr if b_appr is not None else appropriate_batch(spec, c, hw,
                                                            budget=bm)
    gamma = c.k1 * b * b + c.k2 * b + c.k3

    def _r_lower(budget_ms: float) -> float:
        delta = (budget_ms
                 - (c.d_load + c.d_feedback) * b / hw.pcie_bw
                 - c.k5 - c.k_sch * c.n_kernels)
        if delta <= 0:
            raise InfeasibleError(
                f"{spec.name}: fixed latency terms exceed the "
                f"{budget_ms:.3f} ms inference budget "
                f"(delta={delta:.3f} ms)")
        r = gamma / delta - c.k4
        r_units = math.ceil(r / hw.r_unit - 1e-9)
        r_lower = max(hw.r_unit, r_units * hw.r_unit)
        if r_lower > R_MAX + 1e-9:
            raise InfeasibleError(
                f"{spec.name}: needs r={r_lower:.3f} > 100% of a device")
        return min(r_lower, R_MAX)

    try:
        return _r_lower(solved_budget_ms if solved_budget_ms is not None
                        else bm.budget_ms(spec.slo_ms, spec.rate_rps, b))
    except InfeasibleError:
        if bm.mode == "half":
            raise
        _r_lower(spec.slo_ms / 2.0)    # raises if infeasible even at T/2
        return R_MAX


# ---------------------------------------------------------------------------
# Device state during provisioning
# ---------------------------------------------------------------------------

@dataclass
class _Dev:
    """Mutable allocation state for one device."""
    entries: List[Tuple[WorkloadSpec, WorkloadCoefficients, int, float]] = \
        field(default_factory=list)   # (spec, coeffs, batch, r)

    def total(self) -> float:
        return sum(e[3] for e in self.entries)

    def placed(self) -> List[pm.PlacedWorkload]:
        return [pm.PlacedWorkload(coeffs=c, batch=b, r=r)
                for (_, c, b, r) in self.entries]


# ---------------------------------------------------------------------------
# Algorithm 2: alloc_gpus
# ---------------------------------------------------------------------------

def alloc_gpus(dev: _Dev, w_spec: WorkloadSpec, w_coeffs: WorkloadCoefficients,
               w_batch: int, w_r_lower: float,
               hw: HardwareSpec, *,
               budget: BudgetLike = QUEUEING) -> Optional[List[float]]:
    """Try placing workload w on `dev`; returns the new allocation vector
    r_a (existing entries order, w last), or None if the device cannot host
    it within r_max.

    Faithful to Alg. 2: start w at its lower bound, then iteratively grant
    +r_unit to any workload whose predicted t_inf exceeds its inference
    budget (T_slo/2 under ``budget="half"``, the queueing-aware split
    otherwise), until stable or out of resources.
    """
    bm = resolve(budget)
    specs = [e[0] for e in dev.entries] + [w_spec]
    coeffs = [e[1] for e in dev.entries] + [w_coeffs]
    batches = [e[2] for e in dev.entries] + [w_batch]
    r_a = [e[3] for e in dev.entries] + [w_r_lower]
    budgets = [bm.budget_ms(s.slo_ms, s.rate_rps, b)
               for s, b in zip(specs, batches)]

    flag = True
    while sum(r_a) <= R_MAX + 1e-9 and flag:
        flag = False
        placed = [pm.PlacedWorkload(coeffs=c, batch=b, r=r)
                  for c, b, r in zip(coeffs, batches, r_a)]
        pred = pm.predict_device(placed, hw)
        for i, spec in enumerate(specs):
            if pred.per_workload[i].t_inf > budgets[i] + 1e-9:
                r_a[i] = round(r_a[i] + hw.r_unit, 10)
                flag = True
    if sum(r_a) > R_MAX + 1e-9:
        return None
    return r_a


def self_grant(spec: WorkloadSpec, coeffs: WorkloadCoefficients,
               batch: int, r_lower: float, hw: HardwareSpec, *,
               budget: BudgetLike = QUEUEING) -> float:
    """Alg. 2 run for a workload opening a FRESH device (beyond-paper fix,
    see ROADMAP): Theorem 1's Eq. (18) drops the f/F throttling factor,
    so a solo anchor at r_lower can exceed its budget once its power
    demand crosses the cap.  Grant +r_unit until the model predicts
    t_inf within the inference budget — exactly what `alloc_gpus`
    already does for the FIRST workload (devs[0] starts empty), now
    applied to line-14 devices too.  Falls back to the full device when
    even r=1 cannot meet the budget (the residual is then reported
    honestly by `predicted_violations`).
    """
    r_a = alloc_gpus(_Dev(), spec, coeffs, batch, r_lower, hw, budget=budget)
    return r_a[-1] if r_a is not None else R_MAX


# ---------------------------------------------------------------------------
# Replica groups (beyond-paper, docs/provisioning.md): a workload whose
# inference budget is out of reach even SOLO on a full device is split
# into k replicas, each serving a 1/k rate share — instead of clamping
# to r = 1.0 and reporting a guaranteed violation.
# ---------------------------------------------------------------------------

def solo_feasible(spec: WorkloadSpec, coeffs: WorkloadCoefficients,
                  hw: HardwareSpec, *, budget: BudgetLike = QUEUEING,
                  batch: str = "eq17") -> bool:
    """Can the workload meet its inference budget alone on one device,
    INCLUDING the power-throttling effect Theorem 1 drops (the same
    check `self_grant` applies to fresh devices)?"""
    bm = resolve(budget)
    try:
        b = appropriate_batch(spec, coeffs, hw, budget=bm, batch=batch)
        rl = resource_lower_bound(spec, coeffs, hw, b, budget=bm)
    except InfeasibleError:
        return False
    # rl alone is not decisive: R_MAX may be the tightened-budget clamp,
    # and even rl < R_MAX can throttle-fail once the power cap binds.
    # Run Alg. 2 on an empty device — the authoritative check.
    return alloc_gpus(_Dev(), spec, coeffs, b, rl, hw, budget=bm) is not None


def required_replicas(spec: WorkloadSpec, coeffs: WorkloadCoefficients,
                      hw: HardwareSpec, *, budget: BudgetLike = QUEUEING,
                      batch: str = "eq17",
                      k_max: int = K_MAX) -> Optional[int]:
    """Smallest k such that a 1/k-rate replica of ``spec`` is solo-
    feasible (`solo_feasible`); None when NO k <= k_max suffices.  The
    None is deliberate — "feasible as one instance" (1) and "hopeless
    at any split" must stay distinguishable, or a controller would
    merge a working replica group down to one guaranteed-violating
    instance.  Callers keep hopeless workloads at their CURRENT replica
    count (an honest residual) instead of shattering them into k_max
    equally-impossible slivers."""
    for k in range(1, k_max + 1):
        probe = spec if k == 1 else replication.make_replicas(spec, k)[0]
        if solo_feasible(probe, coeffs, hw, budget=budget, batch=batch):
            return k
    return None


# ---------------------------------------------------------------------------
# Theorem-1 probe cache (online control plane): one reconcile pass probes
# the same (spec, budget) pair 3-4 times — required_replicas, _validate,
# then the PlanState edit itself — and a k-replica scale-out probes every
# k' < k again on the next drift.  All probe inputs are frozen/hashable
# (WorkloadCoefficients, BudgetModel, the batch-mode string), so exact-
# key memoization is safe; `BudgetModel.with_burstiness` copies hash by
# VALUE, so an unchanged burstiness floor keeps the cache warm across
# reconcile rounds.
# ---------------------------------------------------------------------------

_INFEASIBLE = object()          # cached-InfeasibleError sentinel


class ProbeCache:
    """Memoizes `appropriate_batch` + `resource_lower_bound` (Theorem 1),
    `solo_feasible` and `required_replicas` across plan edits.

    Keyed by (coeffs, hw name, budget model, batch mode, slo, rate) —
    everything the probes actually read.  InfeasibleError outcomes are
    cached as a sentinel and re-raised fresh with the current spec name.
    ``hits`` / ``misses`` are exposed for the dynamic-sweep benchmark
    rows."""

    def __init__(self) -> None:
        self._t1: Dict[tuple, object] = {}
        self._solo: Dict[tuple, bool] = {}
        self._reps: Dict[tuple, Optional[int]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(spec: WorkloadSpec, c: WorkloadCoefficients, hw: HardwareSpec,
             bm: BudgetModel, batch: str) -> tuple:
        return (c, hw.name, bm, batch, spec.slo_ms, spec.rate_rps)

    def theorem1(self, spec: WorkloadSpec, c: WorkloadCoefficients,
                 hw: HardwareSpec, bm: BudgetModel,
                 batch: str) -> Tuple[int, float]:
        """Cached (b_appr, r_lower); raises InfeasibleError like the
        underlying probes (also when the miss was cached)."""
        key = self._key(spec, c, hw, bm, batch)
        val = self._t1.get(key)
        if val is not None:
            self.hits += 1
            if val is _INFEASIBLE:
                raise InfeasibleError(
                    f"{spec.name}: infeasible (cached Theorem-1 probe)")
            return val          # type: ignore[return-value]
        self.misses += 1
        try:
            b = appropriate_batch(spec, c, hw, budget=bm, batch=batch)
            rl = resource_lower_bound(spec, c, hw, b, budget=bm)
        except InfeasibleError:
            self._t1[key] = _INFEASIBLE
            raise
        self._t1[key] = (b, rl)
        return b, rl

    def solo_feasible(self, spec: WorkloadSpec, c: WorkloadCoefficients,
                      hw: HardwareSpec, bm: BudgetModel, batch: str) -> bool:
        key = self._key(spec, c, hw, bm, batch)
        val = self._solo.get(key)
        if val is not None:
            self.hits += 1
            return val
        self.misses += 1
        val = solo_feasible(spec, c, hw, budget=bm, batch=batch)
        self._solo[key] = val
        return val

    def required_replicas(self, spec: WorkloadSpec, c: WorkloadCoefficients,
                          hw: HardwareSpec, bm: BudgetModel, batch: str,
                          k_max: int = K_MAX) -> Optional[int]:
        key = self._key(spec, c, hw, bm, batch) + (k_max,)
        if key in self._reps:
            self.hits += 1
            return self._reps[key]
        # per-k solo probes go through the solo cache, so a k-replica
        # answer also warms every k' <= k probe for later edits
        for k in range(1, k_max + 1):
            probe = spec if k == 1 else replication.make_replicas(spec, k)[0]
            if self.solo_feasible(probe, c, hw, bm, batch):
                self._reps[key] = k
                return k
        self._reps[key] = None
        return None


# ---------------------------------------------------------------------------
# Algorithm 1: iGniter provisioning
# ---------------------------------------------------------------------------

def _prepare(specs: Sequence[WorkloadSpec],
             profiles: Dict[str, WorkloadCoefficients],
             hw: HardwareSpec, *, budget: BudgetLike = QUEUEING,
             batch: str = "eq17", replicate: bool = False,
             k_max: int = K_MAX
             ) -> List[Tuple[WorkloadSpec, WorkloadCoefficients, int, float]]:
    """Alg. 1 lines 2-3: (b_appr, r_lower) per workload, sorted by
    r_lower descending.  With ``replicate`` a workload that cannot meet
    its budget even solo on a full device is expanded into
    `required_replicas` equal-share replicas (``w#0..w#k-1``), each
    prepared like an ordinary workload at its share rate; stable
    sorting keeps a group's replicas in index order."""
    bm = resolve(budget)
    prepared = []
    for s in specs:
        c = profiles[s.model]
        reps = [s]
        if replicate and not replication.is_replica(s.name):
            k = required_replicas(s, c, hw, budget=bm, batch=batch,
                                  k_max=k_max)
            reps = replication.make_replicas(s, k or 1)
        for rs in reps:
            b = appropriate_batch(rs, c, hw, budget=bm, batch=batch)
            rl = resource_lower_bound(rs, c, hw, b, budget=bm)
            prepared.append((rs, c, b, rl))
    prepared.sort(key=lambda t: -t[3])
    return prepared


def _check_device_cap(used: int, max_devices: Optional[int], name: str,
                      hw: HardwareSpec) -> None:
    """Raise `DeviceCapError` when opening one more device would exceed
    ``max_devices`` (None = uncapped, the historical behavior)."""
    if max_devices is not None and used >= max_devices:
        msg = (f"{name}: device cap {max_devices} reached on {hw.name} "
               f"({used} devices in use); fleet may not grow")
        raise DeviceCapError(msg, per_hw={hw.name: msg})


def provision(specs: Sequence[WorkloadSpec],
              profiles: Dict[str, WorkloadCoefficients],
              hw: HardwareSpec, *,
              config: Optional[PlannerConfig] = None,
              max_devices: Optional[int] = None,
              engine: Optional[str] = None,
              budget: Optional[BudgetLike] = None,
              batch: Optional[str] = None, replicate: Optional[bool] = None,
              k_max: Optional[int] = None) -> ProvisioningPlan:
    """Cost-efficient interference-aware provisioning (Alg. 1).

    All knobs live on ``config`` (a `types.PlannerConfig`); the
    per-knob keywords are deprecated shims (mixing them with
    ``config=`` is a TypeError).  Defaults: vectorized engine, torch
    backend on cuda:0, queueing-aware budget, Eq.-17 batch, no replication.

    ``engine="vec"`` scores all open devices through the batched model in
    one call per placement (``backend="torch"``, the default, runs that
    scoring loop as `perf_model_torch.alloc_all_torch` on
    ``config.device``); ``engine="scalar"`` (with ``backend="numpy"``) is
    the reference per-device loop (identical output, kept as the oracle).

    ``budget`` selects the SLO split handed to Theorem 1 / Alg. 2:
    ``"queueing"`` (default) budgets a tail queueing-delay term per
    workload; ``"half"`` is the paper-faithful fixed T_slo/2 split.

    ``batch`` selects Theorem 1's batch size: ``"eq17"`` (default,
    paper-faithful) or ``"joint"`` (re-optimized jointly with the
    solved budget split — see `appropriate_batch`).

    ``replicate`` (beyond-paper, opt-in) splits any workload that is
    infeasible even SOLO on a full device into `required_replicas`
    equal-rate-share replicas (``w#0..w#k-1``, capped at ``k_max``)
    instead of clamping it to r = 1.0; a plan that never splits is
    bit-identical to ``replicate=False`` output.

    ``max_devices`` caps the fleet: the line-14 fresh-device rule raises
    `DeviceCapError` (with ``per_hw``) instead of silently opening a
    device beyond the cap.  ``None`` (default) keeps the paper's
    uncapped behavior bit-for-bit; a slack cap changes nothing.
    """
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch,
                         replicate=replicate, k_max=k_max)
    bm = resolve(cfg.budget)
    if cfg.engine == "vec":
        return _provision_vec(specs, profiles, hw, cfg,
                              max_devices=max_devices)
    prepared = _prepare(specs, profiles, hw, budget=bm, batch=cfg.batch,
                        replicate=cfg.replicate, k_max=cfg.k_max)

    devs: List[_Dev] = [_Dev()]
    for (s, c, b, rl) in prepared:
        best_q = -1
        best_alloc: Optional[List[float]] = None
        best_inter = R_MAX + 1.0     # r_inter^min
        for q, dev in enumerate(devs):
            r_a = alloc_gpus(dev, s, c, b, rl, hw, budget=bm)
            if r_a is None:
                continue
            # increased resources caused by interference (line 8)
            old = [e[3] for e in dev.entries] + [rl]
            r_inter = sum(max(0.0, na - oa) for na, oa in zip(r_a, old))
            if r_inter < best_inter - 1e-12:
                best_inter = r_inter
                best_q = q
                best_alloc = r_a
        if best_q == -1:
            _check_device_cap(sum(1 for d in devs if d.entries),
                              max_devices, s.name, hw)
            devs.append(_Dev(                              # line 14
                entries=[(s, c, b, self_grant(s, c, b, rl, hw, budget=bm))]))
        else:
            dev = devs[best_q]
            new_entries = []
            for (e, r_new) in zip(dev.entries, best_alloc[:-1]):
                new_entries.append((e[0], e[1], e[2], r_new))
            new_entries.append((s, c, b, best_alloc[-1]))
            dev.entries = new_entries

    plan = ProvisioningPlan(hardware=hw)
    for g, dev in enumerate(devs):
        for (s, c, b, r) in dev.entries:
            plan.placements.append(Placement(workload=s, gpu=g, r=r, batch=b))
    plan.n_gpus = sum(1 for d in devs if d.entries)
    if cfg.replicate:
        _rebalance_replica_shares(plan, profiles, hw)
    return plan


def _argmin_inter(r_inter: "np.ndarray") -> int:
    """Alg. 1 line 8 fold: earliest device whose score is more than 1e-12
    below every earlier candidate (replicates the scalar `<` fold)."""
    best_q, best = -1, R_MAX + 1.0
    for q, ri in enumerate(r_inter):
        if ri < best - 1e-12:
            best_q, best = q, float(ri)
    return best_q


def _provision_vec(specs: Sequence[WorkloadSpec],
                   profiles: Dict[str, WorkloadCoefficients],
                   hw: HardwareSpec,
                   cfg: PlannerConfig, *,
                   max_devices: Optional[int] = None) -> ProvisioningPlan:
    """Alg. 1 over the batched model: one `VecCluster.alloc_all` call
    scores every open device per placement, and the chosen device's
    invariants are refreshed incrementally."""
    bm = resolve(cfg.budget)
    prepared = _prepare(specs, profiles, hw, budget=bm, batch=cfg.batch,
                        replicate=cfg.replicate, k_max=cfg.k_max)

    cl = pmv.VecCluster(hw, budget=bm, backend=cfg.backend,
                        device=cfg.device)
    cl.add_device()
    for (s, c, b, rl) in prepared:
        feasible, rr, rn, r_inter = cl.alloc_all(s, c, b, rl)
        best_q = _argmin_inter(r_inter) if feasible.any() else -1
        if best_q == -1:
            _check_device_cap(sum(1 for g in range(cl.d) if cl.entries[g]),
                              max_devices, s.name, hw)
            q = cl.add_device()                                  # line 14
            cl.add_entry(q, s, c, b, self_grant(s, c, b, rl, hw, budget=bm))
        else:
            cl.set_row_r(best_q, rr[best_q])
            cl.add_entry(best_q, s, c, b, float(rn[best_q]))

    plan = ProvisioningPlan(hardware=hw)
    for g in range(cl.d):
        for i, (s, c, b) in enumerate(cl.entries[g]):
            plan.placements.append(
                Placement(workload=s, gpu=g, r=float(cl.r[g, i]), batch=b))
    plan.n_gpus = sum(1 for g in range(cl.d) if cl.entries[g])
    if cfg.replicate:
        _rebalance_replica_shares(plan, profiles, hw)
    return plan


def _rebalance_replica_shares(plan: ProvisioningPlan,
                              profiles: Dict[str, WorkloadCoefficients],
                              hw: HardwareSpec) -> None:
    """Re-split each replica group's total rate proportionally to the
    predicted serving capacity of its placements (``batch / t_inf`` at
    the GRANTED allocation, co-location included), in place.

    `make_replicas`' equal split models identical homes; Alg. 1 places
    replicas greedily, so later replicas routinely land on busier
    devices where the same r buys a slower pass — the slow replica then
    sets the group's pooled p99.  Capacity-proportional shares route
    traffic toward the replicas with real headroom.  Groups whose
    capacities are bitwise equal (k = 1 trivially, and identical-
    composition homes) are left untouched, keeping those plans
    bit-identical to the equal-split output.
    """
    groups = {b: g for b, g
              in replication.group_placements(plan.placements).items()
              if len(g) > 1}
    if not groups:
        return
    metrics = predicted_plan_metrics(plan, profiles, hw)
    for base in sorted(groups):
        group = groups[base]
        caps = [1000.0 * p.batch / metrics[p.workload.name].t_inf
                for p in group]
        shares = replication.proportional_shares(
            replication.group_rate([p.workload for p in group]), caps)
        if shares is None:
            continue
        for p, share in zip(group, shares):
            p.workload = dataclasses.replace(p.workload, rate_rps=share)


# ---------------------------------------------------------------------------
# Online arrival (paper Sec. 4.2: iGniter is "periodically executed to
# provision GPU resources for newly-arrived inference workloads").
# Unlike gpu-lets, Alg. 2 may grow the allocations of ORIGINALLY-PLACED
# workloads on the chosen device to absorb the newcomer's interference.
# ---------------------------------------------------------------------------

def add_workload(plan: ProvisioningPlan, spec: WorkloadSpec,
                 profiles: Dict[str, WorkloadCoefficients],
                 hw: HardwareSpec, *,
                 config: Optional[PlannerConfig] = None,
                 engine: Optional[str] = None,
                 budget: Optional[BudgetLike] = None,
                 batch: Optional[str] = None,
                 exclude_gpus: Optional[frozenset] = None,
                 pin: Optional[Tuple[int, float]] = None,
                 max_devices: Optional[int] = None,
                 reserved: Optional[Dict[int, float]] = None,
                 telemetry=None) -> ProvisioningPlan:
    """Place one newly-arrived workload into an existing plan (in place of
    a full re-run of Alg. 1): greedy minimum-interference device selection
    with Alg. 2 reallocation, or a fresh device.  The vec engine scores
    every existing device in a single `alloc_all` call.

    ``exclude_gpus`` removes devices from candidacy (the controller's
    health layer quarantines failed/straggling devices); the fresh-
    device fallback still applies, so placement never lands on an
    excluded device.

    ``pin`` is an explicit ``(batch, r_floor)`` that REPLACES the
    Theorem 1 derivation — the health layer's capacity-preserving
    migration: a moved placement keeps the batch and at least the
    resource grant it was provisioned with, rather than whatever the
    controller's drifted budget would re-derive.

    ``max_devices`` caps the fleet like `provision`'s: the fresh-device
    fallback raises `DeviceCapError` (with ``per_hw``) instead of
    growing past the cap.  Every `InfeasibleError` raised here carries
    ``per_hw`` diagnostics, so overload decisions and sweep logs can
    report WHY a grant failed.

    ``reserved`` maps plan gpu id -> armed Sec. 4.2 shadow reservation
    on that device (the controller's predictive tier): a candidate
    whose re-solved residents + newcomer would eat into the reservation
    (total past r = 1.0) is treated as infeasible, so a later shadow
    activation can never overcommit the device.  Reservations
    attributable to the edited workload itself must be excluded by the
    caller.  The fresh-device fallback is naturally reservation-free.

    ``telemetry`` (duck-typed `repro.serving.telemetry.Telemetry`, kept
    untyped to avoid a core->serving import) counts the op under
    ``prov_add`` — every edit op takes the same keyword."""
    if telemetry is not None:
        telemetry.count("prov_add")
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch)
    bm = resolve(cfg.budget)
    c = profiles[spec.model]
    if pin is not None:
        b, rl = int(pin[0]), float(pin[1])
    else:
        try:
            b = appropriate_batch(spec, c, hw, budget=bm, batch=cfg.batch)
            rl = resource_lower_bound(spec, c, hw, b, budget=bm)
        except InfeasibleError as e:
            if not e.per_hw:
                e.per_hw = {hw.name: str(e)}
            raise

    devs: Dict[int, _Dev] = {}
    for p in plan.placements:
        devs.setdefault(p.gpu, _Dev()).entries.append(
            (p.workload, profiles[p.workload.model], p.batch, p.r))
    cand = devs if not exclude_gpus else \
        {g: d for g, d in devs.items() if g not in exclude_gpus}

    best_q, best_alloc, best_inter = -1, None, R_MAX + 1.0
    if cfg.engine == "vec":
        cl = pmv.VecCluster(hw, budget=bm, backend=cfg.backend,
                            device=cfg.device)
        gpu_ids = sorted(cand)
        for g in gpu_ids:
            q = cl.add_device()
            for (s, cc, bb, r) in cand[g].entries:
                cl.add_entry(q, s, cc, bb, r)
        if gpu_ids:
            feasible, rr, rn, r_inter = cl.alloc_all(spec, c, b, rl)
            if reserved:
                resv = np.array([reserved.get(g, 0.0) for g in gpu_ids])
                if resv.any():
                    load = (rr * cl.mask[:cl.d]).sum(axis=1) + rn + resv
                    over = load > 1.0 + 1e-9
                    feasible = feasible & ~over
                    r_inter = np.where(over, np.inf, r_inter)
            row = _argmin_inter(r_inter) if feasible.any() else -1
            if row != -1:
                best_q = gpu_ids[row]
                k = int(cl.n[row])
                best_alloc = [float(x) for x in rr[row, :k]] + [float(rn[row])]
    else:
        for q, dev in sorted(cand.items()):
            r_a = alloc_gpus(dev, spec, c, b, rl, hw, budget=bm)
            if r_a is None:
                continue
            if reserved and (math.fsum(r_a) + reserved.get(q, 0.0)
                             > 1.0 + 1e-9):
                continue
            old = [e[3] for e in dev.entries] + [rl]
            r_inter = sum(max(0.0, na - oa) for na, oa in zip(r_a, old))
            if r_inter < best_inter - 1e-12:
                best_q, best_alloc, best_inter = q, r_a, r_inter

    new_plan = ProvisioningPlan(hardware=plan.hardware or hw)
    if best_q == -1:
        _check_device_cap(len(devs), max_devices, spec.name, hw)
        g_new = (max(devs) + 1) if devs else 0
        new_plan.placements = list(plan.placements) + [
            Placement(workload=spec, gpu=g_new,
                      r=self_grant(spec, c, b, rl, hw, budget=bm), batch=b)]
    else:
        for p in plan.placements:
            if p.gpu != best_q:
                new_plan.placements.append(p)
        dev = devs[best_q]
        for (s, _, bb, _), r_new in zip(dev.entries, best_alloc[:-1]):
            new_plan.placements.append(
                Placement(workload=s, gpu=best_q, r=r_new, batch=bb))
        new_plan.placements.append(
            Placement(workload=spec, gpu=best_q, r=best_alloc[-1], batch=b))
    new_plan.n_gpus = len({p.gpu for p in new_plan.placements})
    return new_plan


# ---------------------------------------------------------------------------
# Incremental plan edits (online control plane, paper Sec. 4.2/4.4):
# resize / remove / migrate one workload of an existing plan without a
# full Alg. 1 re-run.  Each edit touches only the devices involved —
# the same-device resize re-runs Alg. 2 on ONE device, the migrate path
# scores every device in a single vectorized `alloc_all` call — and each
# has a scalar-oracle twin pinned by tests.
# ---------------------------------------------------------------------------

def remove_workload(plan: ProvisioningPlan, name: str, *,
                    telemetry=None) -> ProvisioningPlan:
    """Drop one workload's placement (departure).  Remaining residents
    keep their Alg. 2 grants — with less interference on the device they
    can only get faster, so the plan stays feasible; reclaiming the
    slack is the next resize's job."""
    if telemetry is not None:
        telemetry.count("prov_remove")
    new_plan = ProvisioningPlan(hardware=plan.hardware)
    new_plan.placements = [p for p in plan.placements
                           if p.workload.name != name]
    if len(new_plan.placements) == len(plan.placements):
        raise KeyError(f"workload {name!r} not in plan")
    new_plan.n_gpus = len({p.gpu for p in new_plan.placements})
    return new_plan


def resize_workload(plan: ProvisioningPlan, spec: WorkloadSpec,
                    profiles: Dict[str, WorkloadCoefficients],
                    hw: HardwareSpec, *,
                    config: Optional[PlannerConfig] = None,
                    engine: Optional[str] = None,
                    budget: Optional[BudgetLike] = None,
                    batch: Optional[str] = None,
                    max_devices: Optional[int] = None,
                    reserved: Optional[Dict[int, float]] = None,
                    telemetry=None) -> ProvisioningPlan:
    """Re-place one workload under a NEW spec (arrival-rate / SLO drift):
    recompute Theorem 1 at the new rate, re-run Alg. 2 on its CURRENT
    device (the O(1-device) fast path — covers both growth, absorbing
    more interference, and shrink, releasing slack), and fall back to
    `migrate_workload` when the current device can no longer host it.
    Raised `InfeasibleError`s carry ``per_hw`` diagnostics; the migrate
    fallback honors ``max_devices``.  ``reserved`` holds armed shadow
    reservations out of the re-solve, `add_workload`-style: a same-
    device result that would eat into one falls through to migration."""
    if telemetry is not None:
        telemetry.count("prov_resize")
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch)
    bm = resolve(cfg.budget)
    c = profiles[spec.model]
    try:
        b = appropriate_batch(spec, c, hw, budget=bm, batch=cfg.batch)
        rl = resource_lower_bound(spec, c, hw, b, budget=bm)
    except InfeasibleError as e:
        if not e.per_hw:
            e.per_hw = {hw.name: str(e)}
        raise

    cur = next((p for p in plan.placements if p.workload.name == spec.name),
               None)
    if cur is None:
        raise KeyError(f"workload {spec.name!r} not in plan")
    peers = [p for p in plan.placements
             if p.gpu == cur.gpu and p.workload.name != spec.name]
    residents = [(p.workload, profiles[p.workload.model], p.batch, p.r)
                 for p in peers]
    if cfg.engine == "vec":
        r_a = pmv.alloc_gpus_vec(residents, spec, c, b, rl, hw, budget=bm,
                                 backend=cfg.backend, device=cfg.device)
    else:
        r_a = alloc_gpus(_Dev(entries=residents), spec, c, b, rl, hw,
                         budget=bm)
    if (r_a is not None and reserved
            and (math.fsum(float(x) for x in r_a)
                 + reserved.get(cur.gpu, 0.0) > 1.0 + 1e-9)):
        r_a = None                 # the reservation holds: migrate
    if r_a is None:
        return migrate_workload(plan, spec, profiles, hw,
                                config=cfg.replace(budget=bm),
                                max_devices=max_devices,
                                reserved=reserved)

    peer_r = dict(zip((p.workload.name for p in peers), r_a[:-1]))
    new_plan = ProvisioningPlan(hardware=plan.hardware)
    for p in plan.placements:              # placement order preserved
        if p.workload.name == spec.name:
            new_plan.placements.append(Placement(
                workload=spec, gpu=cur.gpu, r=float(r_a[-1]), batch=b))
        elif p.gpu == cur.gpu:
            new_plan.placements.append(Placement(
                workload=p.workload, gpu=p.gpu,
                r=float(peer_r[p.workload.name]), batch=p.batch))
        else:
            new_plan.placements.append(p)
    new_plan.n_gpus = len({p.gpu for p in new_plan.placements})
    return new_plan


def migrate_workload(plan: ProvisioningPlan, spec: WorkloadSpec,
                     profiles: Dict[str, WorkloadCoefficients],
                     hw: HardwareSpec, *,
                     config: Optional[PlannerConfig] = None,
                     engine: Optional[str] = None,
                     budget: Optional[BudgetLike] = None,
                     batch: Optional[str] = None,
                     exclude_gpus: Optional[frozenset] = None,
                     max_devices: Optional[int] = None,
                     reserved: Optional[Dict[int, float]] = None,
                     telemetry=None) -> ProvisioningPlan:
    """Move one workload to the minimum-interference device that can
    host its (possibly updated) spec — remove + `add_workload`, so the
    destination can also be a fresh device (`self_grant`).
    ``exclude_gpus`` bans devices (health-layer quarantine);
    ``max_devices`` caps the fresh-device fallback; ``reserved`` holds
    armed shadow reservations out of candidacy.  ``telemetry`` counts
    ONE ``prov_migrate`` (the inner remove/add are not
    double-counted)."""
    if telemetry is not None:
        telemetry.count("prov_migrate")
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch)
    return add_workload(remove_workload(plan, spec.name), spec, profiles,
                        hw, config=cfg, exclude_gpus=exclude_gpus,
                        max_devices=max_devices, reserved=reserved)


# ---------------------------------------------------------------------------
# Replica-group plan edits (scale-out / scale-in): re-place one workload
# as k equal-rate-share replicas.  Shares always renormalize to the base
# spec's rate — merging 3 replicas to 2 leaves each survivor at rate/2.
# ---------------------------------------------------------------------------

def _set_replicas(plan: ProvisioningPlan, spec: WorkloadSpec, k: int,
                  profiles: Dict[str, WorkloadCoefficients],
                  hw: HardwareSpec,
                  cfg: PlannerConfig,
                  max_devices: Optional[int] = None) -> ProvisioningPlan:
    """Remove every current replica of ``spec`` (a BASE spec: plain name,
    full workload rate), then `add_workload` each of the k new replicas
    at its rate share — min-interference placement incl. fresh devices
    (capped by ``max_devices``; the input plan is never mutated, so a
    mid-edit `DeviceCapError` leaves it intact)."""
    base = spec.name
    if replication.is_replica(base):
        raise ValueError(f"pass the BASE spec, not replica {base!r}")
    cur = replication.group_placements(plan.placements).get(base)
    if not cur:
        raise KeyError(f"workload {base!r} not in plan")
    out = plan
    for p in cur:
        out = remove_workload(out, p.workload.name)
    for rs in replication.make_replicas(spec, k):
        out = add_workload(out, rs, profiles, hw, config=cfg,
                           max_devices=max_devices)
    return out


def split_workload(plan: ProvisioningPlan, spec: WorkloadSpec, k: int,
                   profiles: Dict[str, WorkloadCoefficients],
                   hw: HardwareSpec, *,
                   config: Optional[PlannerConfig] = None,
                   engine: Optional[str] = None,
                   budget: Optional[BudgetLike] = None,
                   batch: Optional[str] = None,
                   max_devices: Optional[int] = None,
                   telemetry=None) -> ProvisioningPlan:
    """Scale-OUT edit: serve ``spec`` (base name, full rate) with k
    replicas, k strictly above the current count.  Each replica gets an
    equal rate share (summing to ``spec.rate_rps``), its own Theorem-1
    batch/budget at the share rate, and a min-interference placement."""
    if telemetry is not None:
        telemetry.count("prov_split")
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch)
    k_cur = len(replication.group_placements(plan.placements)
                .get(spec.name, ()))
    if k <= k_cur:
        raise ValueError(f"{spec.name!r} already has {k_cur} replicas; "
                         f"split needs k > {k_cur}, got {k}")
    return _set_replicas(plan, spec, k, profiles, hw, cfg, max_devices)


def merge_workload(plan: ProvisioningPlan, spec: WorkloadSpec, k: int,
                   profiles: Dict[str, WorkloadCoefficients],
                   hw: HardwareSpec, *,
                   config: Optional[PlannerConfig] = None,
                   engine: Optional[str] = None,
                   budget: Optional[BudgetLike] = None,
                   batch: Optional[str] = None,
                   max_devices: Optional[int] = None,
                   telemetry=None) -> ProvisioningPlan:
    """Scale-IN edit: drop to k replicas (k below the current count).
    Survivor shares renormalize to ``spec.rate_rps`` — the merged rate
    is re-split equally, never silently lost; ``k = 1`` returns the
    workload to its plain (unreplicated) name."""
    if telemetry is not None:
        telemetry.count("prov_merge")
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch)
    k_cur = len(replication.group_placements(plan.placements)
                .get(spec.name, ()))
    if not 1 <= k < k_cur:
        raise ValueError(f"{spec.name!r} has {k_cur} replicas; "
                         f"merge needs 1 <= k < {k_cur}, got {k}")
    return _set_replicas(plan, spec, k, profiles, hw, cfg, max_devices)


# ---------------------------------------------------------------------------
# Heterogeneous type selection (paper Sec. 5.3, Fig. 20)
# ---------------------------------------------------------------------------

def provision_cheapest(specs: Sequence[WorkloadSpec],
                       profiles_by_hw: Dict[str, Dict[str, WorkloadCoefficients]],
                       hardware: Sequence[HardwareSpec], *,
                       config: Optional[PlannerConfig] = None,
                       max_devices=None,
                       engine: Optional[str] = None,
                       budget: Optional[BudgetLike] = None,
                       batch: Optional[str] = None,
                       replicate: Optional[bool] = None,
                       k_max: Optional[int] = None
                       ) -> Tuple[ProvisioningPlan, HardwareSpec]:
    """Run Alg. 1 per hardware type and pick the cheapest feasible plan.

    ``max_devices`` caps each candidate fleet: an int applies the same
    total cap to every hardware type; a ``{hw_name: cap}`` dict caps
    per type (types absent from the dict stay uncapped).  A type whose
    cap binds is infeasible FOR THAT TYPE and reported through the same
    ``per_hw`` channel as a physics infeasibility.

    When EVERY type is infeasible, the raised `InfeasibleError` carries
    ``per_hw`` — hardware name -> the failing workload's error string —
    alongside the joined message, so m=10k reports stay actionable."""
    cfg = planner_config(config, engine=engine, budget=budget, batch=batch,
                         replicate=replicate, k_max=k_max)
    best: Optional[Tuple[ProvisioningPlan, HardwareSpec]] = None
    errors: Dict[str, str] = {}
    for hw in hardware:
        cap = (max_devices.get(hw.name)
               if isinstance(max_devices, dict) else max_devices)
        try:
            plan = provision(specs, profiles_by_hw[hw.name], hw, config=cfg,
                             max_devices=cap)
        except InfeasibleError as e:
            errors[hw.name] = str(e)
            continue
        if best is None or plan.cost_per_hour() < best[0].cost_per_hour():
            best = (plan, hw)
    if best is None:
        raise InfeasibleError(
            "; ".join(f"{name}: {msg}" for name, msg in errors.items()),
            per_hw=errors)
    return best


def predicted_plan_metrics(plan: ProvisioningPlan,
                           profiles: Dict[str, WorkloadCoefficients],
                           hw: HardwareSpec):
    """Model-predicted latency/throughput for every placement in a plan
    (all devices evaluated through the batched model in one call)."""
    by_gpu = sorted(plan.by_gpu().items())
    devices = [[pm.PlacedWorkload(coeffs=profiles[p.workload.model],
                                  batch=p.batch, r=p.r) for p in pls]
               for _, pls in by_gpu]
    batch = pmv.predict_device_batch(devices, hw)
    out = {}
    for q, (g, pls) in enumerate(by_gpu):
        pred = batch.device(q)
        for p, wp in zip(pls, pred.per_workload):
            out[p.workload.name] = wp
    return out


def predicted_violations(plan: ProvisioningPlan,
                         profiles: Dict[str, WorkloadCoefficients],
                         hw: HardwareSpec, *,
                         config: Optional[PlannerConfig] = None,
                         budget: Optional[BudgetLike] = None) -> List[str]:
    """Workloads whose model-predicted t_inf exceeds their inference
    budget (Constraint 14 check used by the scale sweep).  Pass the same
    ``budget`` the plan was provisioned with: the budget IS the per-
    workload threshold (T_slo/2 under "half").  Replicas are merged to
    BASE names — a workload violates when ANY of its replicas exceeds
    the budget at its rate share — so counts stay comparable across
    replicated and unreplicated plans."""
    cfg = planner_config(config, budget=budget)
    bm = resolve(cfg.budget)
    metrics = predicted_plan_metrics(plan, profiles, hw)
    by_name = {p.workload.name: p for p in plan.placements}
    out: List[str] = []
    seen = set()
    for name, wp in metrics.items():
        if wp.t_inf > bm.budget_ms(by_name[name].workload.slo_ms,
                                   by_name[name].workload.rate_rps,
                                   by_name[name].batch) + 1e-6:
            base = replication.base_name(name)
            if base not in seen:
                seen.add(base)
                out.append(base)
    return out
