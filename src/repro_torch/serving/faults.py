"""Deterministic fault schedules for the serving simulator.

The paper's predictability story (Secs. 4.2/4.4) assumes clean
hardware: every device behaves exactly as the fitted coefficients
predict, forever.  Production fleets do not — devices fail and restart,
and some silently *straggle* (run slower than any fitted model says
they should, see "Understanding GPU Resource Interference One Level
Deeper" in PAPERS.md).  This module supplies the fault side of that
gap as data, in the same style as `repro_torch.serving.traces`: a frozen,
validated schedule object generated up front from a seed and handed to
`simulate_plan(..., faults=...)`, so faulty runs stay byte-identical
across both simulator engines by construction.

Semantics (implemented by the simulator, docs/simulator.md):

  * **Down intervals** ``down[gpu] = [[fail, restart), ...]`` (ms):
    while a device is down no instance on it can START a serving pass
    — in-flight passes complete, arrivals keep queueing as backlog,
    and replicas of the same base workload absorb the dead replica's
    rate share through the runtime re-split.  A ``restart`` of
    ``math.inf`` models a permanent failure (its backlog is never
    served and is reported as ``lost_requests``).
  * **Straggler multipliers** ``slow[gpu]`` (> 1 inflates): every pass
    served on the device takes ``multiplier`` times the modeled
    latency.  The performance model — and therefore the provisioner
    and the controller's plan edits — never sees the multiplier; the
    controller can only DETECT it from measured-vs-predicted residuals
    (the health layer in the JAX package's `repro.serving.controller`).

Schedules are plain per-device data so they compose: `merge` unions
independently generated failure and straggler schedules.

A verbatim copy of the JAX package's ``repro.serving.faults``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultSchedule:
    """Per-device fault plan: down intervals and straggler multipliers.

    ``down`` maps device id -> (K, 2) array of ``[fail, restart)``
    half-open intervals in ms, sorted and non-overlapping (``restart``
    may be ``inf`` for a permanent failure); ``slow`` maps device id ->
    a positive latency multiplier applied to every pass served there
    (stragglers use > 1).  Devices absent from both dicts are clean.
    """
    down: Dict[int, np.ndarray] = field(default_factory=dict)
    slow: Dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        clean_down: Dict[int, np.ndarray] = {}
        for gpu, iv in self.down.items():
            a = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
            a = a[np.argsort(a[:, 0], kind="stable")]
            if a.size and (np.any(a[:, 0] < 0.0)
                           or np.any(a[:, 1] <= a[:, 0])):
                raise ValueError(
                    f"down[{gpu}]: intervals need 0 <= fail < restart")
            if a.shape[0] > 1 and np.any(a[1:, 0] < a[:-1, 1]):
                raise ValueError(f"down[{gpu}]: intervals overlap")
            if a.size:
                clean_down[int(gpu)] = a
        object.__setattr__(self, "down", clean_down)
        clean_slow: Dict[int, float] = {}
        for gpu, m in self.slow.items():
            m = float(m)
            if not m > 0.0:
                raise ValueError(f"slow[{gpu}]: multiplier must be > 0, "
                                 f"got {m}")
            if m != 1.0:
                clean_slow[int(gpu)] = m
        object.__setattr__(self, "slow", clean_slow)

    # -- lookups ------------------------------------------------------------

    def multiplier(self, gpu: int) -> float:
        return self.slow.get(gpu, 1.0)

    def is_down(self, gpu: int, t_ms: float) -> bool:
        iv = self.down.get(gpu)
        if iv is None:
            return False
        k = int(np.searchsorted(iv[:, 0], t_ms, side="right")) - 1
        return k >= 0 and t_ms < iv[k, 1]

    def next_up(self, gpu: int, t_ms: float) -> float:
        """``t_ms`` when the device is up at ``t_ms``, else the restart
        time of the covering down interval (may be ``inf``)."""
        iv = self.down.get(gpu)
        if iv is None:
            return t_ms
        k = int(np.searchsorted(iv[:, 0], t_ms, side="right")) - 1
        if k >= 0 and t_ms < iv[k, 1]:
            return float(iv[k, 1])
        return t_ms

    def boundaries(self) -> List[Tuple[float, int, bool]]:
        """All finite fail/restart boundaries as ``(t_ms, gpu, is_up)``,
        sorted by (t, gpu, is_up) — the deterministic processing order
        both simulator engines share."""
        out: List[Tuple[float, int, bool]] = []
        for gpu, iv in sorted(self.down.items()):
            for f, r in iv:
                out.append((float(f), gpu, False))
                if math.isfinite(r):
                    out.append((float(r), gpu, True))
        out.sort(key=lambda b: (b[0], b[1], b[2]))
        return out

    def downtime_ms(self, horizon_ms: float,
                    gpus: Optional[Sequence[int]] = None) -> float:
        """Total scheduled downtime clipped to ``[0, horizon_ms)``,
        summed over ``gpus`` (default: every scheduled device)."""
        keys = self.down.keys() if gpus is None \
            else [g for g in gpus if g in self.down]
        total = 0.0
        for g in keys:
            iv = self.down[g]
            total += float(np.sum(np.clip(np.minimum(iv[:, 1], horizon_ms)
                                          - iv[:, 0], 0.0, None)))
        return total

    def n_failures(self, horizon_ms: float) -> int:
        """Fail events strictly before the horizon, over all devices."""
        return int(sum(int(np.sum(iv[:, 0] < horizon_ms))
                       for iv in self.down.values()))


# ---------------------------------------------------------------------------
# Schedule generators (seeded, like traces.py)
# ---------------------------------------------------------------------------

def random_failures(n_gpus: int, horizon_ms: float, *,
                    rate_per_min: float, mttr_ms: float,
                    seed: int = 0) -> FaultSchedule:
    """Poisson device failures: each device fails with exponential
    inter-failure gaps at ``rate_per_min`` failures per device-minute
    and stays down for ``mttr_ms``.  Device g's sub-stream is keyed
    ``default_rng([seed, g])``, so a device's fault history does not
    depend on the fleet size.  Failures at or past ``horizon_ms`` are
    dropped (their backlog effects could never be observed)."""
    if rate_per_min < 0.0 or mttr_ms <= 0.0:
        raise ValueError("need rate_per_min >= 0 and mttr_ms > 0")
    down: Dict[int, np.ndarray] = {}
    if rate_per_min == 0.0:
        return FaultSchedule(down=down)
    gap_ms = 60_000.0 / rate_per_min
    for g in range(n_gpus):
        rng = np.random.default_rng([seed, g])
        t = float(rng.exponential(gap_ms))
        ivs: List[List[float]] = []
        while t < horizon_ms:
            ivs.append([t, t + mttr_ms])
            t = t + mttr_ms + float(rng.exponential(gap_ms))
        if ivs:
            down[g] = np.asarray(ivs)
    return FaultSchedule(down=down)


def stragglers(n_gpus: int, *, frac: float, multiplier: float = 1.5,
               seed: int = 0) -> FaultSchedule:
    """A seeded ``frac`` of devices straggle at ``multiplier`` times the
    modeled pass latency for the whole run (persistent stragglers)."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac must be in [0, 1], got {frac}")
    rng = np.random.default_rng(seed)
    k = int(round(frac * n_gpus))
    picks = rng.permutation(n_gpus)[:k]
    return FaultSchedule(slow={int(g): float(multiplier) for g in picks})


def merge(*schedules: FaultSchedule) -> FaultSchedule:
    """Union independently generated schedules (e.g. failures +
    stragglers).  Down intervals are concatenated per device (overlaps
    raise via validation); a device's multiplier may be set by at most
    one schedule."""
    down: Dict[int, list] = {}
    slow: Dict[int, float] = {}
    for fs in schedules:
        for g, iv in fs.down.items():
            down.setdefault(g, []).extend(iv.tolist())
        for g, m in fs.slow.items():
            if g in slow and slow[g] != m:
                raise ValueError(f"conflicting multipliers for device {g}")
            slow[g] = m
    return FaultSchedule(down={g: np.asarray(v) for g, v in down.items()},
                         slow=slow)
