"""Dynamic arrival-rate traces for the serving simulator.

The static pipeline fixes every workload's arrival rate at t=0 and holds
it for the whole horizon; the paper's runtime half (Sec. 4.2/4.4) reacts
to rate changes instead.  This module supplies the *load* side of that
loop: per-workload piecewise-constant rate multipliers over the horizon
(`Trace`) plus the canonical shapes the dynamic benchmarks exercise —

  * ``diurnal``     a smooth 1x -> peak -> 1x ramp (one "day" per horizon
                    by default), discretized to piecewise-constant steps,
  * ``step_spike``  an abrupt flash-crowd multiplier over a window,
  * ``churn``       workload departures (rate -> 0 at a cut time) and
                    arrivals (rate 0 until an onset time), the
                    add/remove half of the control plane's job.

Traces are what the control plane's estimators chase: the diurnal ramp
drives sustained drift past the reconciler's hysteresis band, the
step spike probes the debounce (a short flash crowd must not trigger a
permanent reallocation), and churn exercises departure/re-arrival — the
shared vocabulary (band, debounce, burstiness floor) is defined in
docs/control-plane.md.

Arrival streams are pre-generated per instance by `simulator._setup`
from per-instance RNG streams shared by BOTH engines, so any trace stays
byte-identical across the scalar oracle and the vectorized engine by
construction.  Trace keys are BASE workload names: a replica group
(``w#0..w#k-1``, docs/simulator.md) draws ONE pooled stream for ``w``
at the summed share rate, which the simulator then splits
rate-proportionally.  `gen_arrivals` implements the two arrival
processes:

  * deterministic ("constant-rate" analogue): arrivals at the inverse of
    the cumulative rate integral, i.e. evenly spaced *in expected count*
    with a uniform phase — reduces to evenly spaced arrivals on a flat
    trace;
  * Poisson: thinning of a homogeneous Poisson process at the peak rate
    (acceptance probability scale(t)/scale_max), the standard exact
    sampler for non-homogeneous Poisson processes.

A verbatim copy of the JAX package's ``repro.serving.traces``: the draws
keep numpy's ``default_rng`` keys, so both packages make the same
arrivals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Trace:
    """Per-workload piecewise-constant rate multipliers.

    ``edges`` are the K+1 segment boundaries in ms (strictly increasing,
    starting at 0); ``scales[name][k]`` multiplies the workload's
    provisioned ``rate_rps`` over ``[edges[k], edges[k+1])``.  Workloads
    absent from ``scales`` keep their static rate; past ``edges[-1]``
    the final segment's scale extends indefinitely.
    """
    edges: np.ndarray
    scales: Dict[str, np.ndarray]

    def __post_init__(self):
        e = np.asarray(self.edges, dtype=np.float64)
        if e.ndim != 1 or e.size < 2 or e[0] != 0.0 \
                or np.any(np.diff(e) <= 0.0):
            raise ValueError("edges must be 1-D, start at 0 and be "
                             "strictly increasing")
        object.__setattr__(self, "edges", e)
        clean = {}
        for name, s in self.scales.items():
            s = np.asarray(s, dtype=np.float64)
            if s.shape != (e.size - 1,):
                raise ValueError(f"scales[{name!r}] must have "
                                 f"{e.size - 1} segments, got {s.shape}")
            if np.any(s < 0.0):
                raise ValueError(f"scales[{name!r}] has negative rates")
            clean[name] = s
        object.__setattr__(self, "scales", clean)

    # -- lookups ------------------------------------------------------------

    def segments(self, name: str, horizon_ms: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(edges, scales) covering exactly [0, horizon_ms): clipped when
        the trace is longer, final-scale-extended when shorter."""
        s = self.scales[name]
        e = self.edges
        if e[-1] < horizon_ms:
            e = np.concatenate([e, [horizon_ms]])
            s = np.concatenate([s, [s[-1]]])
        k = int(np.searchsorted(e, horizon_ms, side="left"))
        e = np.concatenate([e[:k], [horizon_ms]])
        return e, s[:e.size - 1]

    def scale_at(self, name: str, t_ms: float) -> float:
        if name not in self.scales:
            return 1.0
        k = int(np.searchsorted(self.edges, t_ms, side="right")) - 1
        k = min(max(k, 0), self.scales[name].size - 1)
        return float(self.scales[name][k])

    def mean_scale(self, name: str, horizon_ms: float) -> float:
        """Time-weighted mean multiplier over [0, horizon_ms) — the
        expected-throughput correction for SLO rate checks."""
        if name not in self.scales:
            return 1.0
        e, s = self.segments(name, horizon_ms)
        return float((s * np.diff(e)).sum() / horizon_ms)

    def max_scale(self, name: str, horizon_ms: float) -> float:
        if name not in self.scales:
            return 1.0
        _, s = self.segments(name, horizon_ms)
        return float(s.max()) if s.size else 1.0


# ---------------------------------------------------------------------------
# Trace generators
# ---------------------------------------------------------------------------

def constant(names: Sequence[str], horizon_ms: float, *,
             scale: float = 1.0) -> Trace:
    """Flat multiplier (scale=1.0 is the no-drift control case)."""
    edges = np.array([0.0, float(horizon_ms)])
    return Trace(edges=edges,
                 scales={n: np.array([scale]) for n in names})


def diurnal(names: Sequence[str], horizon_ms: float, *,
            peak: float = 2.0, period_ms: Optional[float] = None,
            resolution_ms: float = 250.0, phase: float = 0.0) -> Trace:
    """Smooth 1x -> ``peak`` -> 1x ramp, one period per horizon by
    default: scale(t) = 1 + (peak-1) * (1 - cos(2 pi (t/P + phase))) / 2,
    discretized to midpoint-sampled piecewise-constant segments."""
    horizon_ms = float(horizon_ms)
    period = float(period_ms) if period_ms is not None else horizon_ms
    n_seg = max(2, int(math.ceil(horizon_ms / resolution_ms)))
    edges = np.linspace(0.0, horizon_ms, n_seg + 1)
    mid = 0.5 * (edges[:-1] + edges[1:])
    s = 1.0 + (peak - 1.0) * 0.5 * (1.0 - np.cos(
        2.0 * math.pi * (mid / period + phase)))
    return Trace(edges=edges, scales={n: s.copy() for n in names})


def step_spike(names: Sequence[str], horizon_ms: float, *,
               at_ms: float, duration_ms: float,
               scale: float = 2.0, base: float = 1.0) -> Trace:
    """Flash crowd: ``base`` -> ``scale`` over [at, at+duration) -> base."""
    horizon_ms = float(horizon_ms)
    hi = min(float(at_ms) + float(duration_ms), horizon_ms)
    edges = [0.0]
    segs = []
    if at_ms > 0.0:
        edges.append(float(at_ms))
        segs.append(base)
    if hi > at_ms:
        edges.append(hi)
        segs.append(scale)
    if hi < horizon_ms:
        edges.append(horizon_ms)
        segs.append(base)
    e = np.array(edges)
    s = np.array(segs)
    return Trace(edges=e, scales={n: s.copy() for n in names})


def churn(names: Sequence[str], horizon_ms: float, *,
          departures: Optional[Mapping[str, float]] = None,
          arrivals: Optional[Mapping[str, float]] = None,
          base: float = 1.0) -> Trace:
    """Workload churn: ``departures[name]`` cuts the rate to 0 at that
    time; ``arrivals[name]`` holds the rate at 0 UNTIL that time (the
    workload "arrives" mid-trace).  Everything else stays at ``base``."""
    departures = dict(departures or {})
    arrivals = dict(arrivals or {})
    horizon_ms = float(horizon_ms)
    cuts = sorted({0.0, horizon_ms}
                  | {min(float(t), horizon_ms) for t in departures.values()}
                  | {min(float(t), horizon_ms) for t in arrivals.values()})
    edges = np.array(cuts)
    mid = 0.5 * (edges[:-1] + edges[1:])
    scales = {}
    for n in names:
        s = np.full(mid.size, base)
        if n in departures:
            s[mid >= departures[n]] = 0.0
        if n in arrivals:
            s[mid < arrivals[n]] = 0.0
        scales[n] = s
    return Trace(edges=edges, scales=scales)


def random_churn(names: Sequence[str], horizon_ms: float, *,
                 depart_frac: float = 0.1, arrive_frac: float = 0.1,
                 seed: int = 0) -> Trace:
    """Seeded convenience wrapper for the benchmark suite: a random
    ``depart_frac`` of workloads depart and a disjoint ``arrive_frac``
    arrive, each at a uniform time in the middle half of the horizon."""
    rng = np.random.default_rng(seed)
    names = list(names)
    k_dep = int(round(depart_frac * len(names)))
    k_arr = int(round(arrive_frac * len(names)))
    picks = rng.permutation(len(names))[:k_dep + k_arr]
    t = rng.uniform(0.25 * horizon_ms, 0.75 * horizon_ms,
                    size=k_dep + k_arr)
    departures = {names[int(i)]: float(tt)
                  for i, tt in zip(picks[:k_dep], t[:k_dep])}
    arrivals = {names[int(i)]: float(tt)
                for i, tt in zip(picks[k_dep:], t[k_dep:])}
    return churn(names, horizon_ms, departures=departures,
                 arrivals=arrivals)


# ---------------------------------------------------------------------------
# Arrival generation over a trace (consumed by simulator._setup)
# ---------------------------------------------------------------------------

def gen_arrivals(rate_rps: float, edges: np.ndarray, scales: np.ndarray,
                 horizon_ms: float, poisson: bool,
                 rng: np.random.Generator) -> np.ndarray:
    """All arrival times in [0, horizon) for one instance under a
    piecewise-constant rate ``rate_rps * scales[k]`` over
    ``[edges[k], edges[k+1])``.  The stream depends only on the RNG
    stream handed in — byte-identical across simulator engines.
    """
    if rate_rps <= 0.0 or scales.size == 0 or float(scales.max()) <= 0.0:
        return np.empty(0)
    widths = np.diff(edges)
    rate_ms = rate_rps * scales / 1000.0
    if not poisson:
        # inverse of the cumulative rate integral at integer counts
        cum = np.concatenate([[0.0], np.cumsum(rate_ms * widths)])
        total = cum[-1]
        u = max(float(rng.uniform(0.0, 1.0)), 1e-12)    # phase in (0, 1]
        if total <= u:
            return np.empty(0)
        targets = u + np.arange(int(math.floor(total - u)) + 1)
        targets = targets[targets < total]
        # k with cum[k] < target <= cum[k+1]; minimality of searchsorted
        # guarantees rate_ms[k] > 0 there (flat segments are skipped)
        k = np.searchsorted(cum[1:], targets, side="left")
        return edges[k] + (targets - cum[k]) / rate_ms[k]
    # Poisson: thin a homogeneous process at the peak rate
    smax = float(scales.max())
    rmax_ms = rate_rps * smax / 1000.0
    period = 1.0 / rmax_ms
    chunks = []
    last = 0.0
    est = max(16, int(horizon_ms / period * 1.2))
    while last < horizon_ms:
        gaps = rng.exponential(period, size=est)
        ts = last + np.cumsum(gaps)
        chunks.append(ts)
        last = float(ts[-1])
        est = max(16, est // 4)
    cand = np.concatenate(chunks)
    cand = cand[cand < horizon_ms]
    seg = np.clip(np.searchsorted(edges, cand, side="right") - 1,
                  0, scales.size - 1)
    accept = rng.uniform(0.0, 1.0, size=cand.size) * smax < scales[seg]
    return cand[accept]
