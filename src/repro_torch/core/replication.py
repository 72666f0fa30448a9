"""Replica groups: one workload served by k >= 1 instances.

iGniter places exactly ONE instance per workload, so a workload
provisioned near r = 1.0 has zero headroom: once its rate ramps past
what a full device can serve, no re-placement can help it (the m=1000
diurnal residual, see ROADMAP "Replication across devices").  ParvaGPU
(arXiv:2409.14447) splits a workload's demand across multiple GPU
segments and Dynamic Space-Time Scheduling (arXiv:1901.00041) motivates
replica-level load balancing; this module supplies the SHARED vocabulary
for that beyond-paper extension — the naming scheme and rate-share
arithmetic the provisioner, simulator and controller all agree on.

Conventions (docs/provisioning.md "Replica groups"):

  * A workload ``w`` split k >= 2 ways is served by replicas named
    ``w#0 .. w#k-1`` — ordinary `WorkloadSpec`s whose ``rate_rps`` is
    the replica's RATE SHARE.  Shares always sum to the base workload's
    rate (`make_replicas` splits equally; renormalize by re-making).
  * ``k = 1`` keeps the PLAIN name: a single-replica "group" is
    byte-for-byte the pre-replication workload, which is what keeps
    un-split plans (and their simulations) bit-identical to PR-4-era
    output.
  * Everything downstream of a spec treats replicas as independent
    workloads (placement, Alg. 2 grants, budgets at the SHARE rate);
    only arrival generation and violation accounting merge them back to
    the base name (`base_name`).

A verbatim copy of the JAX package's ``repro.core.replication``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.types import Placement, WorkloadSpec

SEP = "#"


def base_name(name: str) -> str:
    """``"w#3" -> "w"``; plain names pass through."""
    return name.split(SEP, 1)[0]


def replica_index(name: str) -> Optional[int]:
    """``"w#3" -> 3``; None for a plain (unreplicated) name."""
    if SEP not in name:
        return None
    return int(name.split(SEP, 1)[1])


def is_replica(name: str) -> bool:
    return SEP in name


def replica_name(base: str, j: int) -> str:
    return f"{base}{SEP}{j}"


def make_replicas(spec: WorkloadSpec, k: int) -> List[WorkloadSpec]:
    """k replica specs with equal rate shares summing to ``spec.rate_rps``.

    ``spec`` must carry a plain (base) name; ``k = 1`` returns ``[spec]``
    unchanged — the plain-name convention above.
    """
    if is_replica(spec.name):
        raise ValueError(f"{spec.name!r} is already a replica name; "
                         "split from the base spec")
    if k < 1:
        raise ValueError(f"need k >= 1 replicas, got {k}")
    if k == 1:
        return [spec]
    share = spec.rate_rps / k
    return [dataclasses.replace(spec, name=replica_name(spec.name, j),
                                rate_rps=share)
            for j in range(k)]


def group_specs(specs: Iterable[WorkloadSpec]
                ) -> Dict[str, List[WorkloadSpec]]:
    """Group (replica) specs by base name, each group sorted by replica
    index (plain names sort first)."""
    out: Dict[str, List[WorkloadSpec]] = {}
    for s in specs:
        out.setdefault(base_name(s.name), []).append(s)
    for group in out.values():
        group.sort(key=lambda s: replica_index(s.name) or 0)
    return out


def group_placements(placements: Sequence[Placement]
                     ) -> Dict[str, List[Placement]]:
    """Group a plan's placements by base workload name (replica order)."""
    out: Dict[str, List[Placement]] = {}
    for p in placements:
        out.setdefault(base_name(p.workload.name), []).append(p)
    for group in out.values():
        group.sort(key=lambda p: replica_index(p.workload.name) or 0)
    return out


def group_rate(group: Sequence[WorkloadSpec]) -> float:
    """Total workload rate = sum of the group's rate shares."""
    return float(sum(s.rate_rps for s in group))


def group_priority(group: Sequence[Placement]) -> int:
    """Admission class of a replica group (all replicas inherit the base
    spec's ``priority`` through `make_replicas`)."""
    return int(group[0].workload.priority)


def preemption_order(groups: Dict[str, List[Placement]]) -> List[str]:
    """Deterministic victim order for the admission layer's preemption
    (docs/control-plane.md, Overload): lowest priority class first, then
    LARGEST device footprint (total granted r) — each shed frees the
    most capacity per victim — then base name as the stable tie-break.
    Both simulator engines and both reconciler paths must shed in this
    exact order or controlled runs lose bit-identity.
    """
    def key(base: str):
        g = groups[base]
        return (group_priority(g), -sum(p.r for p in g), base)
    return sorted(groups, key=key)


def proportional_shares(total: float,
                        caps: Sequence[float]) -> Optional[List[float]]:
    """Rate shares proportional to per-replica serving capacity.

    `make_replicas` splits equally, which is only load-balanced when
    every replica lands on an identical device composition; on unequal
    devices the slow replica becomes the group's p99.  Returns ``total``
    split as ``caps / sum(caps)`` — or None when every capacity is
    (bitwise) identical, so callers skip the rewrite and equal-device
    groups stay bit-identical to the equal-split plan.
    """
    if not caps:
        return None
    if any(not c > 0.0 for c in caps):
        raise ValueError(f"capacities must be positive, got {list(caps)}")
    if all(c == caps[0] for c in caps):
        return None
    s = float(sum(caps))
    return [float(total) * float(c) / s for c in caps]
