"""Baseline provisioning strategies the paper compares against (Sec. 5.1):

  FFD+      first-fit-decreasing, allocates exactly r_lower (interference-
            oblivious both in placement and allocation).
  FFD++     FFD placement but allocation via Alg. 2 (`alloc_gpus`) — the
            paper's Fig. 19 ablation.
  GSLICE+   GSLICE patched with our placement; tunes r and b *reactively*
            and separately per workload with a fixed threshold, oblivious
            to co-located workloads (can over-subscribe a device).
  gpu-lets+ throughput-maximizing resource sizing over a coarse grid
            {20,40,50,60,80}%, at most TWO workloads per device, best-fit
            placement, pairwise-only interference estimate, and never
            re-adjusts the originally-placed workload.

A copy of the JAX package's ``repro.core.baselines`` on the port's
provisioner: FFD++'s batched scorer runs on ``PlannerConfig.backend`` /
``device`` (the torch backend on the card by default).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perf_model as pm
from repro_torch.core import perf_model_vec as pmv
from repro_torch.core import provisioner as prov
from repro_torch.core.queueing import BudgetLike, QUEUEING, resolve
from repro_torch.core.types import (HardwareSpec, Placement, PlannerConfig,
                              ProvisioningPlan, WorkloadCoefficients,
                              WorkloadSpec, planner_config)

R_MAX = 1.0


# ---------------------------------------------------------------------------
# FFD+ / FFD++
# ---------------------------------------------------------------------------

def provision_ffd(specs: Sequence[WorkloadSpec],
                  profiles: Dict[str, WorkloadCoefficients],
                  hw: HardwareSpec, *, use_alloc_gpus: bool = False,
                  config: Optional[PlannerConfig] = None,
                  engine: Optional[str] = None,
                  budget: Optional[BudgetLike] = None) -> ProvisioningPlan:
    cfg = planner_config(config, engine=engine, budget=budget)
    bm = resolve(cfg.budget)
    prepared = prov._prepare(specs, profiles, hw, budget=bm)
    if use_alloc_gpus and cfg.engine == "vec":
        return _provision_ffd_vec(prepared, hw, bm, backend=cfg.backend,
                                  device=cfg.device)

    devs: List[prov._Dev] = []
    for (s, c, b, rl) in prepared:
        placed = False
        for dev in devs:
            if use_alloc_gpus:
                r_a = prov.alloc_gpus(dev, s, c, b, rl, hw, budget=bm)
                if r_a is not None:
                    dev.entries = [
                        (e[0], e[1], e[2], r_new)
                        for e, r_new in zip(dev.entries, r_a[:-1])
                    ] + [(s, c, b, r_a[-1])]
                    placed = True
                    break
            else:
                if dev.total() + rl <= R_MAX + 1e-9:
                    dev.entries.append((s, c, b, rl))
                    placed = True
                    break
        if not placed:
            devs.append(prov._Dev(entries=[(s, c, b, rl)]))

    plan = ProvisioningPlan(hardware=hw)
    for g, dev in enumerate(devs):
        for (s, c, b, r) in dev.entries:
            plan.placements.append(Placement(workload=s, gpu=g, r=r, batch=b))
    plan.n_gpus = len(devs)
    return plan


def _provision_ffd_vec(prepared, hw: HardwareSpec,
                       budget: BudgetLike = QUEUEING, *,
                       backend: str = "numpy",
                       device=None) -> ProvisioningPlan:
    """FFD++ through the batched scorer: Alg. 2 runs against every open
    device in one call, first-fit picks the earliest feasible one."""
    cl = pmv.VecCluster(hw, budget=budget, backend=backend, device=device)
    for (s, c, b, rl) in prepared:
        q_fit = -1
        if cl.d:
            feasible, rr, rn, _ = cl.alloc_all(s, c, b, rl)
            fit = np.where(feasible)[0]
            q_fit = int(fit[0]) if fit.size else -1
        if q_fit == -1:
            q = cl.add_device()
            cl.add_entry(q, s, c, b, rl)
        else:
            cl.set_row_r(q_fit, rr[q_fit])
            cl.add_entry(q_fit, s, c, b, float(rn[q_fit]))

    plan = ProvisioningPlan(hardware=hw)
    for g in range(cl.d):
        for i, (s, c, b) in enumerate(cl.entries[g]):
            plan.placements.append(
                Placement(workload=s, gpu=g, r=float(cl.r[g, i]), batch=b))
    plan.n_gpus = cl.d
    return plan


# ---------------------------------------------------------------------------
# GSLICE+
# ---------------------------------------------------------------------------

MeasureFn = Callable[[List[Tuple[WorkloadSpec, WorkloadCoefficients, int, float]]],
                     List[Tuple[float, float]]]
# measure_fn(device entries) -> [(observed avg latency ms, observed rps)] per entry


def provision_gslice(specs: Sequence[WorkloadSpec],
                     profiles: Dict[str, WorkloadCoefficients],
                     hw: HardwareSpec, measure_fn: MeasureFn, *,
                     rounds: int = 5, threshold: float = 0.10,
                     config: Optional[PlannerConfig] = None,
                     budget: Optional[BudgetLike] = None
                     ) -> ProvisioningPlan:
    """GSLICE+ — iGniter's *placement* (per the paper's patch) but GSLICE's
    allocation policy: start from an equal spatial split of each device,
    then run `rounds` of reactive, per-workload threshold tuning against
    observed latency/throughput.  Each workload is tuned separately with
    no awareness of co-located demand, so a device can end up
    over-subscribed (sum r > 100%) — the pathology of Fig. 15/16 — and
    resources are reclaimed whenever latency sits below the threshold
    band, which trades SLO safety for utilization."""
    cfg = planner_config(config, budget=budget)
    bm = resolve(cfg.budget)
    base = prov.provision(specs, profiles, hw, config=cfg.replace(budget=bm))
    devs: Dict[int, List[Tuple[WorkloadSpec, WorkloadCoefficients, int, float]]] = {}
    for p in base.placements:
        devs.setdefault(p.gpu, []).append(
            (p.workload, profiles[p.workload.model], p.batch, p.r))
    # GSLICE initial state: equal split, batch grown from 1 reactively
    for g, entries in devs.items():
        share = round((R_MAX / len(entries)) / hw.r_unit) * hw.r_unit
        devs[g] = [(s, c, 1, share) for (s, c, b, r) in entries]

    for g, entries in devs.items():
        for _ in range(rounds):
            obs = measure_fn(entries)
            new_entries = []
            changed = False
            for (s, c, b, r), (lat, rps) in zip(entries, obs):
                target = bm.budget_ms(s.slo_ms, s.rate_rps, b)
                if lat > target:                        # violating -> grow
                    r = min(R_MAX, round(r + 2 * hw.r_unit, 10))
                    changed = True
                elif lat < (1.0 - threshold) * target:  # reclaim (oscillates)
                    r = max(hw.r_unit, round(r - hw.r_unit, 10))
                    changed = True
                if rps < s.rate_rps and b < 64:         # throughput short
                    b = min(64, b + max(1, int(b * 0.5)))
                    changed = True
                elif rps > (1 + threshold) * s.rate_rps and b > 1 and lat > target:
                    b = b - 1
                    changed = True
                new_entries.append((s, c, b, r))
            entries[:] = new_entries
            if not changed:
                break

    plan = ProvisioningPlan(hardware=hw)
    for g, entries in devs.items():
        for (s, c, b, r) in entries:
            plan.placements.append(Placement(workload=s, gpu=g, r=r, batch=b))
    plan.n_gpus = len(devs)
    return plan


# ---------------------------------------------------------------------------
# gpu-lets+
# ---------------------------------------------------------------------------

_GPULETS_CHOICES = (0.2, 0.4, 0.5, 0.6, 0.8)


def _solo_throughput(c: WorkloadCoefficients, b: int, r: float,
                     hw: HardwareSpec) -> float:
    t_gpu = c.k_sch * c.n_kernels + c.k_act(b, r)
    return 1000.0 * b / (t_gpu + c.t_feedback(b, hw.pcie_bw))


def _most_efficient_r(spec: WorkloadSpec, c: WorkloadCoefficients, b: int,
                      hw: HardwareSpec, knee: float = 0.30,
                      budget: BudgetLike = QUEUEING) -> float:
    """gpu-lets sizing: the grid point where marginal throughput efficiency
    knees, grown until the solo latency budget and arrival rate are met."""
    bm = resolve(budget)
    budget_ms = bm.budget_ms(spec.slo_ms, spec.rate_rps, b)
    choice = _GPULETS_CHOICES[-1]
    for i, r in enumerate(_GPULETS_CHOICES[:-1]):
        cur = _solo_throughput(c, b, r, hw)
        nxt = _solo_throughput(c, b, _GPULETS_CHOICES[i + 1], hw)
        if (nxt - cur) / max(cur, 1e-9) < knee:
            choice = r
            break
    idx = _GPULETS_CHOICES.index(choice)
    while idx < len(_GPULETS_CHOICES) - 1:
        r = _GPULETS_CHOICES[idx]
        me = pm.PlacedWorkload(coeffs=c, batch=b, r=r)
        lat = pm.predict_workload(me, [], hw).t_inf
        if (lat <= budget_ms
                and _solo_throughput(c, b, r, hw) >= spec.rate_rps):
            break
        idx += 1
    return _GPULETS_CHOICES[idx]


def provision_gpulets(specs: Sequence[WorkloadSpec],
                      profiles: Dict[str, WorkloadCoefficients],
                      hw: HardwareSpec, *,
                      config: Optional[PlannerConfig] = None,
                      budget: Optional[BudgetLike] = None) -> ProvisioningPlan:
    cfg = planner_config(config, budget=budget)
    bm = resolve(cfg.budget)
    prepared = []
    for s in specs:
        c = profiles[s.model]
        b = prov.appropriate_batch(s, c, hw,   # paper-modified batch policy
                                   budget=bm)
        r = _most_efficient_r(s, c, b, hw, budget=bm)
        prepared.append((s, c, b, r))
    prepared.sort(key=lambda t: -t[3])

    # best-fit with at most 2 workloads per device; pairwise interference
    # check for the NEW workload only (the original is never re-checked).
    # All candidate devices are scored through one batched-model call.
    devs: List[List[Tuple[WorkloadSpec, WorkloadCoefficients, int, float]]] = []
    for (s, c, b, r) in prepared:
        me = pm.PlacedWorkload(coeffs=c, batch=b, r=r)
        cand = [i for i, entries in enumerate(devs)
                if len(entries) < 2
                and sum(e[3] for e in entries) + r <= R_MAX + 1e-9]
        best_i, best_left = -1, None
        if cand:
            batch_pred = pmv.predict_device_batch(
                [[pm.PlacedWorkload(coeffs=e[1], batch=e[2], r=e[3])
                  for e in devs[i]] + [me] for i in cand], hw)
            for q, i in enumerate(cand):
                # newcomer occupies the last slot of candidate device q
                lat = float(batch_pred.t_inf[q, len(devs[i])])
                if lat > bm.budget_ms(s.slo_ms, s.rate_rps, b):
                    continue
                left = R_MAX - sum(e[3] for e in devs[i]) - r
                if best_left is None or left < best_left:
                    best_i, best_left = i, left
        if best_i == -1:
            devs.append([(s, c, b, r)])
        else:
            devs[best_i].append((s, c, b, r))

    plan = ProvisioningPlan(hardware=hw)
    for g, entries in enumerate(devs):
        for (s, c, b, r) in entries:
            plan.placements.append(Placement(workload=s, gpu=g, r=r, batch=b))
    plan.n_gpus = len(devs)
    return plan
