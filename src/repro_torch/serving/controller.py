"""Closed-loop control plane: online re-provisioning under dynamic load.

The static pipeline (Alg. 1/2 + the queueing-aware budget split)
provisions once at t=0; the paper's runtime half (Sec. 4.2: the
inference workload placer is "periodically executed", Sec. 4.4: the GPU
resource scaler reacts to load changes) has three moving parts, built
here on the simulator's unified ``adjust_fn`` hook
(``adjust_scope="cluster"``).  docs/control-plane.md is the narrative
companion; the terminology here (band, debounce, burstiness floor,
split/merge) matches it.

  1. **Estimators** (`ArrivalEstimator`): per-workload EWMA arrival
     rate, trend, and burstiness (squared coefficient of variation of
     inter-arrival gaps) fed from each instance's ``recent_arrivals``
     monitor window.  Replicas of one workload feed a single estimator
     with their merged (sorted) windows — the slices partition the
     pooled stream, so the merge IS the workload's arrival process.
     CV^2 ~ 0 on deterministic traces, ~ 1 on Poisson, >> 1 on spikes —
     exactly the `BudgetModel.burstiness` scale, so the budget split
     adapts to the measured arrival process.

  2. **Reconciler** (`Reconciler`): drift detection behind a
     **hysteresis band** — reconfigure only when the estimate leaves
     max(band, noise_sigmas * sigma) of the plan rate, with an
     asymmetric **debounce** (fast up: under-capacity compounds into
     backlog; slow down: releasing capacity on noise is the expensive
     error) so Poisson noise never triggers.  On sustained drift it
     re-solves the queueing budget with the online burstiness estimate
     (floored at the provisioned value — the **burstiness floor**:
     adaptation only tightens), re-optimizes the batch size jointly
     with the split (``batch="joint"``), and issues incremental plan
     edits: `provisioner.resize_workload` (same-device Alg. 2 re-run),
     `remove_workload` (departures), `add_workload` (re-arrivals and
     fresh devices), and — the replica layer — **split** (scale-out: a
     workload infeasible even solo at r = 1.0 becomes
     `required_replicas` rate-share replicas ``w#0..w#k-1``) and
     **merge** (scale-in on the slow path; survivor shares renormalize
     to the full rate).  Each edit is O(devices touched) through
     `VecCluster`'s cached invariants, with the scalar engines as the
     pinned oracle.

  3. **Controller** (`Controller`): the ``adjust_fn`` adapter.  Each
     control period it feeds the estimators, runs the reconciler, and
     applies the resulting plan deltas to the live instances — r /
     batch / gpu mutations, plus the replica lifecycle: renaming ``w``
     to ``w#0`` on the first split, APPENDING fresh `ServedInstance`s
     for scale-out (the simulator routes them a slice of the pooled
     arrival stream), and parking merged-away replicas at zero rate
     share.  A drift-free run performs ZERO reconfigurations and
     leaves the plan bit-identical — the no-op guarantee CI pins.

Determinism: everything the controller observes (``recent_arrivals``
slices of the pre-generated arrival streams) is byte-identical across
simulator engines, so a controlled run — including its splits and the
re-split arrival routing — is engine-identical too, modulo the
wall-clock ``reconfig_latency_ms`` stat.  A `Controller` is STATEFUL —
construct a fresh one per simulation run.

A copy of the JAX package's ``repro.serving.controller``.  Its one
intended difference is where the persistent `PlanState` mirror runs:
the planner's ``backend`` and ``device`` (`PlannerConfig`) reach its
`VecCluster`, so with the default ``backend="torch"`` every
min-interference placement and migration scores all devices in one
launch of the Alg. 2 grant-loop kernel on ``device`` (None -> cuda:0,
raising without CUDA; "cpu" runs its plain float64 torch version when
asked for by name).  ``backend="numpy"`` is the reference's oracle,
byte for byte, and the only backend of ``engine="scalar"``.  Same-device
resizes, Theorem 1, the estimators, the health, admission and forecast
tiers stay on the host in both.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import perf_model as pm
from repro_torch.core import perf_model_vec as pmv
from repro_torch.core import provisioner as prov
from repro_torch.core import replication
from repro_torch.core.queueing import BudgetLike, QUEUEING, resolve
from repro_torch.core.types import (HardwareSpec, Placement, PlannerConfig,
                                    ProvisioningPlan, WorkloadCoefficients,
                                    WorkloadSpec, planner_config)
from repro_torch.device import resolve_device
from repro_torch.serving import telemetry as telemetry_mod
from repro_torch.serving.simulator import ServedInstance


# ---------------------------------------------------------------------------
# Online estimators
# ---------------------------------------------------------------------------

@dataclass
class ControllerConfig:
    """Knobs for the estimator / hysteresis / reconciliation loop."""
    alpha: float = 0.4           # EWMA weight for the arrival rate
    burst_alpha: float = 0.3     # EWMA weight for inter-arrival moments
    band_up: float = 0.15        # reconfigure when rate > (1+band_up)x plan
    band_down: float = 0.30      # ... or rate < (1-band_down)x plan
    noise_sigmas: float = 4.0    # widen bands to this many sigmas of the
                                 # smoothed Poisson counting noise, so a
                                 # noise-only run never breaches (the band
                                 # is max(band, k*sigma/mean))
    burst_band: float = 1.5      # ... or cv2 above budget burstiness by this
    debounce_up: int = 1         # ticks before reacting to up-drift (fast:
                                 # under-capacity compounds into backlog)
    debounce_down: int = 3       # ticks before releasing capacity (slow:
                                 # shrinking on noise is the expensive error)
    debounce_burst: int = 3      # ticks before a burstiness-only re-budget
                                 # (cv2 estimates are the noisiest signal)
    headroom: float = 0.15       # provision up-drift to rate*(1+headroom)
    drain_cap: float = 1.0       # backlog-drain demand cap, x estimated rate
    depart_frac: float = 0.02    # est rate below this x plan rate: departed
    depart_missed: float = 8.0   # expected arrivals missed in a zero-
                                 # arrival stretch before declaring departure
    min_gap_obs: int = 4         # gaps needed before trusting a cv2 update
    # -- health layer (failure / straggler detection + quarantine) --
    health: bool = True          # False disables the health layer entirely
    health_fail_ticks: int = 2   # consecutive no-completion-with-backlog
                                 # ticks before a device is declared failed
                                 # (>= 2: the first stalled tick may
                                 # straddle the actual failure instant)
    health_straggler_factor: float = 1.7
                                 # a device's median measured/predicted
                                 # pass-latency residual above this many
                                 # times the fleet median residual at the
                                 # same effective batch = straggling.
                                 # Clean devices carry up to ~1.5x fleet-
                                 # relative fitted-model bias (m=1000,
                                 # batch-normalized); a straggler needs
                                 # multiplier x its bias to clear 1.7 —
                                 # >= ~2.2x is reliably caught, milder
                                 # stragglers hide inside model error
    health_straggler_abs: float = 2.1
                                 # absolute backstop: a raw median
                                 # residual above this flags the device
                                 # even when fleet-relative scoring
                                 # cannot (stragglers pile into the
                                 # full-batch buckets their deep queues
                                 # create and normalize each other
                                 # away).  Clean fitted-model bias tops
                                 # out ~1.8x at m=1000; a 2.5x
                                 # multiplier lands >= ~2.4x
    health_straggler_ticks: int = 2
                                 # consecutive straggling ticks before
                                 # quarantine (residuals are noisier than
                                 # completions, but lognormal noise cannot
                                 # sustain a 30% median residual)
    health_drain_util: float = 0.6
                                 # eviction drain headroom: a victim
                                 # group whose worst member's fitted
                                 # utilization (x the residual guard)
                                 # exceeds this is re-placed as enough
                                 # equal-share replicas to put every
                                 # member under it — a victim at its
                                 # throughput ceiling has ~zero drain
                                 # rate and holds the backlog it
                                 # accumulated during detection latency
                                 # forever
    health_residual_guard: float = 1.3
                                 # fitted->true utilization guard used
                                 # in that split decision: the fitted
                                 # model under-predicts true service
                                 # time by up to ~1.3-1.8x, so a
                                 # fitted utilization near 1 can be a
                                 # TRUE utilization past 1
    health_readmit_s: float = 30.0
                                 # quarantine probation length: at expiry
                                 # the device is PROBED (an active canary
                                 # measures its CURRENT residual) and
                                 # readmitted only when it probes clean —
                                 # a still-straggling device fails the
                                 # probe and its probation restarts, so a
                                 # permanent straggler stays quarantined
                                 # forever.  Without a canary attached the
                                 # legacy timer readmission applies.
    k_max: int = prov.K_MAX      # replica ceiling for scale-out (a drifted
                                 # workload infeasible even solo at r=1.0
                                 # is split into <= k_max rate-share
                                 # replicas; 1 disables replication)
    # -- overload / admission layer (device cap + priority classes) --
    max_devices: Optional[int] = None
                                 # fleet cap for the reconciler's plan
                                 # edits: None = the historical uncapped
                                 # behavior; an int routes any edit that
                                 # would open device max_devices + 1
                                 # through the admission layer
                                 # (preemption -> brownout -> queue-or-
                                 # shed, docs/control-plane.md Overload)
    brownout_mult: float = 1.5   # working-SLO multiplier tried before a
                                 # cap-refused grant is queued or shed: a
                                 # looser SLO shrinks the resource demand.
                                 # Targets keep the TRUE SLO (recovery is
                                 # retried on every later breach) and
                                 # per-class violation stats measure
                                 # against the creation-time ``slo0``, so
                                 # a brownout cannot hide violations
    readmit_backoff_s: float = 5.0
                                 # shed-workload readmission retry gap:
                                 # each failed re-admission attempt backs
                                 # off this long before probing the cap
                                 # again
    planner: Optional[PlannerConfig] = None
                                 # planner knobs (backend/engine/budget/
                                 # batch/k_max) for the reconciler's plan
                                 # edits; None = PlannerConfig(batch=
                                 # "joint"), the controller's historical
                                 # default.  A Reconciler/Controller
                                 # ``config=`` argument overrides this,
                                 # which overrides the legacy ``k_max``
                                 # field above.
    # -- predictive tier (forecast-armed Sec. 4.2 shadows) --
    forecast: bool = False       # master switch for the proactive tier:
                                 # False (default) keeps every code path
                                 # byte-identical to the reactive build
    forecast_horizon: float = 3.0
                                 # control periods of trend extrapolation:
                                 # forecast = rate + max(0, trend) x this
                                 # (plus the seasonal lookup when a
                                 # period is detected)
    forecast_band: float = 0.30  # minimum relative rise of the forecast
                                 # over the plan rate before the
                                 # predictive tier may act
    forecast_sigmas: float = 10.0
                                 # widen that band to this many sigmas of
                                 # the smoothed counting noise — larger
                                 # than the reactive noise_sigmas because
                                 # the horizon extrapolation amplifies
                                 # trend noise ~3x.  This band alone
                                 # keeps constant-rate Poisson input
                                 # forecast-silent at any seed: measured
                                 # worst single-tick margin is ~0.84 of
                                 # the band (worst consecutive PAIR ~0.64)
                                 # over 180k noise-only ticks
                                 # (tests/test_forecast.py)
    forecast_debounce: int = 1   # consecutive forecast breaches before
                                 # acting.  1 by design: the predictive
                                 # tier must act at the FIRST tick a flash
                                 # crowd is visible or the reactive pass
                                 # wins the race (it fires at
                                 # debounce_up=1 and raises the target the
                                 # forecast is compared against) — noise
                                 # immunity comes from the 10-sigma band,
                                 # not the debounce.  Raise it to trade
                                 # spike lead time for extra insurance.
    forecast_hold: int = 5       # breach-free ticks before armed shadows
                                 # are released (never while one is
                                 # ACTIVE — yanking r_eff mid-drain would
                                 # re-blow the tail it just absorbed)
    forecast_history: int = 64   # per-workload rate-history windows kept
                                 # for the autocorrelation period scan
                                 # (bounded: the deque IS the memory cap)
    forecast_min_period: int = 4 # smallest candidate period (windows) —
                                 # below this the EWMA trend already
                                 # tracks the swing
    forecast_autocorr: float = 0.5
                                 # autocorrelation peak needed to declare
                                 # a period (white noise at lag k is
                                 # ~N(0, 1/n) — far below this)
    forecast_snr: float = 4.0    # series variance must exceed this many
                                 # times the Poisson counting-noise
                                 # variance before the period scan runs
                                 # at all: flat + noise never qualifies
    shadow_extra: float = 0.10   # Sec. 4.2 shadow reservation size per
                                 # armed instance (capped by the free
                                 # capacity of its device), matching
                                 # ``simulate_plan(shadow_extra=...)``
    # -- observability --
    cost_retention: int = 4096   # rows kept in `Controller.costs` (the
                                 # (t_s, $/h) ring sampled every tick);
                                 # the ring's ``total``/``dropped``
                                 # expose overflow.  The unbounded
                                 # ``cost_series`` list this replaces
                                 # grew for the whole run


class ArrivalEstimator:
    """EWMA arrival-rate + CV^2 burstiness from monitor-window arrivals.

    Fed once per control period with the arrivals observed in that
    window.  Inter-arrival gaps are chained across windows through the
    last seen arrival so burstiness sees inter-burst gaps too — a spike
    train's signature lives BETWEEN windows as much as within them.
    """

    def __init__(self, rate_rps: float, cfg: Optional[ControllerConfig] = None,
                 burstiness: float = 1.0):
        self.cfg = cfg or ControllerConfig()
        self.rate_rps = float(rate_rps)   # prior: the provisioned rate
        self.trend_rps = 0.0              # EWMA per-window rate delta
        self.cv2 = float(burstiness)      # prior: the budget's burstiness
        self.n_windows = 0
        self.n_gaps = 0
        self.ever_active = False          # any arrival seen at all
        self.empty_ms = 0.0               # current zero-arrival stretch
        self.window_ms = 1000.0           # last observation window
        self._last_arrival: Optional[float] = None
        self._gap_buf: List[float] = []   # gaps awaiting a moment update
        self._g1: Optional[float] = None  # EWMA mean gap [ms]
        self._g2: Optional[float] = None  # EWMA mean squared gap [ms^2]
        # bounded raw per-window rate history for the predictive tier's
        # autocorrelation period scan (maintained unconditionally: one
        # float per control period, and the deque caps the memory)
        self.history: deque = deque(
            maxlen=max(int(self.cfg.forecast_history), 8))

    @property
    def projected_rps(self) -> float:
        """Rate one control period ahead: EWMA estimates lag a ramp by
        construction, so up-drift sizing extrapolates the trend (never
        below the smoothed estimate — a falling trend is not projected,
        shrinking is the hysteresis band's slow path)."""
        return self.rate_rps + max(0.0, self.trend_rps)

    def rate_sigma(self) -> float:
        """Std of the smoothed rate estimate under Poisson counting
        noise: sqrt(R / T_window) shrunk by the EWMA's variance factor
        alpha / (2 - alpha) — what the hysteresis band must exceed for
        noise-only input to stay quiet."""
        var_factor = self.cfg.alpha / (2.0 - self.cfg.alpha)
        lam = max(self.rate_rps * self.window_ms / 1000.0, 1.0)
        return (math.sqrt(lam * var_factor) * 1000.0 / self.window_ms
                if self.window_ms > 0 else 0.0)

    def detect_period(self) -> Optional[int]:
        """Dominant period of the rate history, in control periods, or
        None.  Demeaned autocorrelation over lags in
        [forecast_min_period, n/2]; a lag qualifies only when its
        coefficient clears `forecast_autocorr` AND the series variance
        clears `forecast_snr` x the Poisson counting-noise variance —
        the double gate is what keeps constant-rate Poisson input (whose
        lag-k autocorrelation is ~N(0, 1/n)) period-free at any seed.
        Among qualifying lags the smallest one within 10% of the best
        coefficient wins, so a fundamental beats its own harmonics."""
        cfg = self.cfg
        n = len(self.history)
        max_lag = n // 2
        if max_lag < cfg.forecast_min_period:
            return None
        x = np.asarray(self.history, dtype=np.float64)
        x = x - x.mean()
        denom = float(np.dot(x, x))
        if denom <= 0.0:
            return None
        # counting-noise floor: a Poisson window of lam = R * T_w
        # arrivals has rate variance R / T_w — flat + noise sits AT this
        # floor while a real seasonal swing carries far more power
        noise_var = self.rate_rps * 1000.0 / max(self.window_ms, 1e-9)
        if denom / n < cfg.forecast_snr * max(noise_var, 1e-12):
            return None
        lags = np.arange(cfg.forecast_min_period, max_lag + 1)
        acf = np.array([float(np.dot(x[:-k], x[k:])) / denom
                        for k in lags])
        best = float(acf.max())
        if best < cfg.forecast_autocorr:
            return None
        return int(lags[np.argmax(acf >= best - 0.1 * abs(best))])

    def forecast_rps(self, horizon: float) -> float:
        """Short-horizon rate forecast: trend extrapolation ``rate +
        max(0, trend) * horizon`` (a falling trend is not projected —
        shrinking stays on the reactive slow path), raised to the
        seasonal level one detected period back at t + horizon when the
        history carries a significant period.  Never below the current
        smoothed estimate, and monotone in the trend — a linear ramp's
        forecasts rise monotonically (tests/test_forecast.py)."""
        f = self.rate_rps + max(0.0, self.trend_rps) * max(horizon, 0.0)
        p = self.detect_period()
        n = len(self.history)
        if p is not None and n > p:
            idx = n - 1 + int(round(horizon)) - p
            while idx >= n:          # horizon beyond one period: wrap
                idx -= p
            if idx >= 0:
                h = list(self.history)
                lo, hi = max(0, idx - 1), min(n, idx + 2)
                seasonal = float(np.mean(h[lo:hi]))  # 3-point smooth
                f = max(f, seasonal)
        return f

    def observe(self, arrivals: np.ndarray, window_ms: float) -> None:
        cfg = self.cfg
        arrivals = np.asarray(arrivals, dtype=np.float64)
        inst_rate = arrivals.size * 1000.0 / max(window_ms, 1e-9)
        self.history.append(inst_rate)
        prev = self.rate_rps
        self.rate_rps += cfg.alpha * (inst_rate - self.rate_rps)
        self.trend_rps += cfg.alpha * ((self.rate_rps - prev)
                                       - self.trend_rps)
        self.n_windows += 1
        self.window_ms = window_ms

        if arrivals.size == 0:
            self.empty_ms += window_ms
            return
        self.empty_ms = 0.0
        self.ever_active = True
        if self._last_arrival is not None:
            gaps = np.diff(np.concatenate([[self._last_arrival], arrivals]))
        else:
            gaps = np.diff(arrivals)
        self._last_arrival = float(arrivals[-1])
        # buffer gaps across windows so low-rate workloads (fewer than
        # min_gap_obs arrivals per period) still accumulate burstiness
        # evidence instead of discarding every window's gaps
        self._gap_buf.extend(gaps.tolist())
        if len(self._gap_buf) >= cfg.min_gap_obs:
            g = np.asarray(self._gap_buf)
            self._gap_buf = []
            m1 = float(np.mean(g))
            m2 = float(np.mean(g * g))
            if self._g1 is None:
                self._g1, self._g2 = m1, m2
            else:
                self._g1 += cfg.burst_alpha * (m1 - self._g1)
                self._g2 += cfg.burst_alpha * (m2 - self._g2)
            self.n_gaps += int(g.size)
            if self._g1 > 0.0:
                self.cv2 = max(0.0, self._g2 / (self._g1 * self._g1) - 1.0)


# ---------------------------------------------------------------------------
# Health layer: failure / straggler detection from live telemetry
# ---------------------------------------------------------------------------

@dataclass
class HealthReport:
    """One tick's verdicts: devices newly detected failed / straggling,
    and quarantined devices whose probation expired."""
    dead: List[int]
    stragglers: List[int]
    readmit: List[int]


def _pass_groups(svc: np.ndarray) -> List[tuple]:
    """Recover (service_ms, batch) per serving pass from per-request
    ``latency - wait``: every request of a pass completes at the same
    instant it started serving, so consecutive equal values ARE a pass.
    The 1e-6 ms tolerance absorbs float re-association; two REAL passes
    landing within it would only merge into one conservative group."""
    if svc.size == 0:
        return []
    brk = np.flatnonzero(np.abs(np.diff(svc)) > 1e-6) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [svc.size]])
    return [(float(svc[s]), int(e - s)) for s, e in zip(starts, ends)]


class HealthMonitor:
    """Device-health detection from what a serving system can actually
    measure — completion counts and per-request latencies — never from
    the fault schedule (the controller must DETECT faults, not read
    them).

    * **Failure**: a device whose instances have pending queued work but
      complete NOTHING for `health_fail_ticks` consecutive control
      periods.  A healthy device completes many passes per period, so
      the only false-positive window is the tick straddling the failure.
    * **Straggler**: per pass, the ratio of measured service time
      (``latency - wait``, exactly the pass's realized inference time)
      to the fitted interference model's prediction at the pass's
      effective batch; each sample is normalized by the fleet median
      ratio at the same effective batch, and a device whose median
      normalized residual sits `health_straggler_factor` above the
      fleet median of device medians for `health_straggler_ticks` ticks
      is straggling.  The fitted model's residual vs the true physics
      varies with effective batch and composition, but the FLEET shares
      that bias — double normalization cancels it, while a straggler's
      multiplier exists outside the fitted coefficient space entirely
      and cannot cancel.  Needs >= 2 reporting devices (a lone device IS
      the fleet median).  Predictions are memoized per composition.

    Quarantined devices are skipped by detection; at probation expiry
    (`health_readmit_s`) the device is PROBED — ``observe``'s ``canary``
    callable measures its current residual — and readmitted only when
    the probe comes back clean (residual <= `health_straggler_factor`).
    A failed probe restarts probation, so a PERMANENT straggler is never
    readmitted; without a canary the legacy timer readmission applies
    (re-detection then has to re-trip, repeating the outage — the bug
    the probe fixes).
    """

    def __init__(self, profiles: Dict[str, WorkloadCoefficients],
                 hw: HardwareSpec, cfg: ControllerConfig,
                 telemetry: Optional["telemetry_mod.Telemetry"] = None):
        self.profiles = profiles
        self.hw = hw
        self.cfg = cfg
        self.telemetry = telemetry
        self.quarantined: Dict[int, tuple] = {}   # gpu -> (kind, t_s)
        self._completed: Dict[int, int] = {}      # inst idx -> last count
        self._seen: Dict[int, int] = {}           # inst idx -> consumed lats
        self._gpu: Dict[int, int] = {}            # inst idx -> last device
        self._fail_streak: Dict[int, int] = {}
        self._slow_streak: Dict[int, int] = {}
        self._pred: Dict[tuple, float] = {}       # composition -> t_inf

    def _predicted(self, inst: ServedInstance,
                   peers: List[ServedInstance], nb: int) -> float:
        key = (inst.spec.model, nb, round(inst.r_eff, 9),
               tuple(sorted((p.spec.model, p.batch, round(p.r_eff, 9))
                            for p in peers)))
        t = self._pred.get(key)
        if t is None:
            placed = [pm.PlacedWorkload(
                coeffs=self.profiles[inst.spec.model], batch=nb,
                r=inst.r_eff)]
            placed += [pm.PlacedWorkload(
                coeffs=self.profiles[p.spec.model], batch=p.batch,
                r=p.r_eff) for p in peers]
            t = pm.predict_device(placed, self.hw).per_workload[0].t_inf
            self._pred[key] = t
        return t

    def observe(self, now_s: float,
                instances: List[ServedInstance],
                canary=None) -> HealthReport:
        cfg = self.cfg
        by_gpu: Dict[int, List[int]] = {}
        for i, inst in enumerate(instances):
            by_gpu.setdefault(inst.gpu, []).append(i)
        dead: List[int] = []
        strag: List[int] = []
        dev_samples: Dict[int, List[Tuple[int, float]]] = {}
        for g in sorted(by_gpu):
            if g in self.quarantined:
                continue
            idxs = by_gpu[g]
            progress = any(instances[i].completed
                           > self._completed.get(i, 0) for i in idxs)
            pending = any(len(instances[i].queue) > 0 for i in idxs)
            if pending and not progress:
                streak = self._fail_streak.get(g, 0) + 1
            else:
                streak = 0
            self._fail_streak[g] = streak
            if streak >= cfg.health_fail_ticks:
                dead.append(g)
                continue
            samples: List[Tuple[int, float]] = []   # (nb, ratio)
            for i in idxs:
                inst = instances[i]
                if self._gpu.get(i, inst.gpu) != inst.gpu:
                    continue       # migrated mid-window: the new pass
                                   # samples still blame the OLD device
                lo = self._seen.get(i, 0)
                lats = inst.latencies
                if len(lats) <= lo:
                    continue
                svc = (np.asarray(lats[lo:])
                       - np.asarray(inst.waits[lo:]))
                peers = [instances[k] for k in idxs if k != i]
                for (service, nb) in _pass_groups(svc):
                    nbe = min(nb, inst.batch)
                    pred = self._predicted(inst, peers, nbe)
                    if pred > 0.0:
                        samples.append((nbe, service / pred))
            if samples:
                dev_samples[g] = samples
        # fleet-relative straggler test: the fitted model carries a
        # residual vs the true physics that depends on the effective
        # batch served (partial passes mispredict worst) and on the
        # device's composition — clean devices measure anywhere in
        # ~[0.9, 1.6]x predicted, so an absolute threshold cannot
        # separate model bias from a genuine straggler.  The FLEET
        # shares the bias; a straggler does not share its multiplier.
        # So: collapse each device to its median ratio per effective
        # batch, normalize by the LEAVE-ONE-OUT fleet median of the
        # other devices' medians at that batch (cancels the
        # nb-dependent bias without letting a device that dominates a
        # batch bucket normalize its own multiplier away), and compare
        # the per-device median of those normalized residuals to the
        # fleet median of device scores (cancels the rest).  A batch
        # bucket scores a device only when >= 2 OTHER devices report
        # it; a lone device is always exactly the fleet median.
        dev_nb_med: Dict[int, Dict[int, float]] = {}
        for g, samples in dev_samples.items():
            per_nb: Dict[int, List[float]] = {}
            for nb, r in samples:
                per_nb.setdefault(nb, []).append(r)
            dev_nb_med[g] = {nb: float(np.median(v))
                             for nb, v in per_nb.items()}
        bucket: Dict[int, List[Tuple[int, float]]] = {}
        for g, med_by_nb in dev_nb_med.items():
            for nb, v in med_by_nb.items():
                bucket.setdefault(nb, []).append((g, v))
        score: Dict[int, float] = {}
        for g, med_by_nb in dev_nb_med.items():
            normed = []
            for nb, v in med_by_nb.items():
                # nearest populated batch bucket: a straggler's slow
                # passes accumulate deeper queues, so it often serves
                # at a batch no clean device reports — its own bucket
                # would be empty after leave-one-out and it would never
                # be scored.  The fleet bias falls with nb, so on a tie
                # prefer the SMALLER nb (larger reference, conservative)
                cands = [nb2 for nb2, pts in bucket.items()
                         if sum(1 for (h, _) in pts if h != g) >= 2]
                if not cands:
                    continue
                nb_star = min(cands, key=lambda x: (abs(x - nb), x))
                others = [x for (h, x) in bucket[nb_star] if h != g]
                normed.append(v / float(np.median(others)))
            if normed:
                score[g] = float(np.median(normed))
        if len(dev_samples) >= 2:
            fleet = float(np.median(list(score.values()))) if score else 0.0
            raw = {g: float(np.median([r for _, r in samples]))
                   for g, samples in dev_samples.items()}
            if self.telemetry is not None:
                # the measured-vs-fitted residual series: exactly the
                # triple the quarantine comparison below reads, recorded
                # instead of discarded (docs/observability.md, drift)
                for g in sorted(dev_samples):
                    self.telemetry.record_drift(
                        now_s, g, raw[g], score.get(g, 0.0), fleet)
            for g in sorted(by_gpu):
                if g in self.quarantined or g in dead:
                    continue
                flagged = (g in score and fleet > 0.0
                           and score[g] / fleet
                           > cfg.health_straggler_factor)
                # absolute backstop: when every device in a batch
                # bucket straggles, fleet-relative scoring is blind —
                # but the raw residual is not
                flagged = flagged or (g in raw
                                      and raw[g] > cfg.health_straggler_abs)
                if flagged:
                    slow = self._slow_streak.get(g, 0) + 1
                else:
                    slow = 0
                self._slow_streak[g] = slow
                if slow >= cfg.health_straggler_ticks:
                    strag.append(g)
        for i, inst in enumerate(instances):
            self._completed[i] = inst.completed
            self._seen[i] = len(inst.latencies)
            self._gpu[i] = inst.gpu
        readmit: List[int] = []
        for g in sorted(self.quarantined):
            kind, t0 = self.quarantined[g]
            if now_s - t0 < cfg.health_readmit_s:
                continue
            if canary is not None:
                # active probe, not a timer: readmit only when the device
                # measures clean RIGHT NOW.  A still-down device probes
                # at infinity, a permanent straggler at its multiplier —
                # both fail and restart probation, so they never re-ingest
                # placements just to re-trip detection.
                if not (canary(g, now_s * 1000.0)
                        <= cfg.health_straggler_factor):
                    self.quarantined[g] = (kind, now_s)
                    continue
            readmit.append(g)
        return HealthReport(dead=dead, stragglers=strag, readmit=readmit)


# ---------------------------------------------------------------------------
# Persistent plan state: the hot path for incremental edits
# ---------------------------------------------------------------------------

class PlanState:
    """A live `VecCluster` mirror of the reconciler's current plan.

    The provisioner-level edits (`resize_workload` & co.) are
    plan-in/plan-out and rebuild their cluster state per call — exact,
    oracle-friendly, but O(cluster) each, which at m=1000 puts the
    controller's own latency (the Sec. 5.5 overhead number) in the tens
    of seconds.  This mirror keeps the cluster's cached invariants
    ALIVE across edits so each one costs only the devices it touches:
    a same-device resize re-runs Alg. 2 against that device alone, a
    migration scores every device in ONE vectorized `alloc_all`, and a
    departure is a single `remove_entry`.  Allocation outcomes match
    the sequential provisioner ops (entry order within a device differs,
    which the model's symmetric sums make irrelevant) — pinned by
    `tests/test_controller.py`; emptied devices are additionally reused
    as migration targets instead of stranding them.
    """

    def __init__(self, plan: ProvisioningPlan,
                 profiles: Dict[str, WorkloadCoefficients],
                 hw: HardwareSpec, budget: BudgetLike = QUEUEING,
                 backend: str = "numpy",
                 probes: Optional[prov.ProbeCache] = None,
                 max_devices: Optional[int] = None,
                 shadow: Optional[Dict[str, float]] = None,
                 device=None):
        self.hw = hw
        self.profiles = profiles
        self.max_devices = max_devices
        self.hardware = plan.hardware or hw
        self.probes = probes
        self.cl = pmv.VecCluster(hw, budget=budget, backend=backend,
                                 device=device)
        self.row_gpus: List[int] = []          # row q -> plan gpu id
        self.home: Dict[str, int] = {}         # workload name -> row q
        by_gpu: Dict[int, List[Placement]] = {}
        for p in plan.placements:
            by_gpu.setdefault(p.gpu, []).append(p)
        for g in sorted(by_gpu):               # add_workload's row order
            q = self.cl.add_device()
            self.row_gpus.append(g)
            for p in by_gpu[g]:
                self.cl.add_entry(q, p.workload,
                                  profiles[p.workload.model], p.batch, p.r)
                self.home[p.workload.name] = q
        self._next_gpu = (max(by_gpu) + 1) if by_gpu else 0
        # plan gpu ids placement must avoid (health-layer quarantine);
        # the Reconciler keeps this in sync with its quarantine set
        self.banned: set = set()
        # Sec. 4.2 shadow reservations, workload name -> shadow_r.
        # Shared BY REFERENCE with the owning Reconciler's armed book,
        # so every placement sweep sees the reservation the moment it
        # is granted: an activation may push a device to r + shadow_r
        # but never past 1.0 (tests/test_forecast.py pins this)
        self.shadow: Dict[str, float] = shadow if shadow is not None \
            else {}

    def _row_reserved(self, exclude: Optional[str] = None) -> np.ndarray:
        """Per-row armed shadow reservation: the capacity a monitor-tick
        activation may claim, which placement must treat as spoken for."""
        out = np.zeros(self.cl.d)
        for name, sr in self.shadow.items():
            if name == exclude:
                continue
            q = self.home.get(name)
            if q is not None:
                out[q] += sr
        return out

    def set_budget(self, budget: BudgetLike) -> None:
        self.cl.set_budget(budget)

    def remove(self, name: str) -> None:
        q = self.home.pop(name)
        self.cl.remove_entry(q, self._slot_at(q, name))

    def _slot_at(self, q: int, name: str) -> int:
        for i, (s, _, _) in enumerate(self.cl.entries[q]):
            if s.name == name:
                return i
        raise KeyError(name)

    def _place(self, spec: WorkloadSpec, c: WorkloadCoefficients,
               b: int, rl: float) -> None:
        """Min-interference placement over ALL devices (one vectorized
        Alg. 2 sweep) with the fresh-device `self_grant` fallback —
        `add_workload` semantics against the live cluster."""
        cl = self.cl
        feasible, rr, rn, r_inter = cl.alloc_all(spec, c, b, rl)
        if self.banned:
            mask = np.fromiter((g in self.banned for g in self.row_gpus),
                               dtype=bool, count=len(self.row_gpus))
            feasible = feasible & ~mask
            r_inter = np.where(mask, np.inf, r_inter)
        if self.shadow:
            # armed reservations are spoken-for capacity: a row whose
            # re-solved residents + newcomer + reservations would exceed
            # r = 1.0 is infeasible for this placement (the activation
            # headroom must survive every edit)
            resv = self._row_reserved(exclude=spec.name)
            if resv.any():
                load = (rr * cl.mask[:cl.d]).sum(axis=1) + rn + resv
                over = load > 1.0 + 1e-9
                if over.any():
                    feasible = feasible & ~over
                    r_inter = np.where(over, np.inf, r_inter)
        if self.max_devices is not None:
            used = sum(1 for q in range(cl.d) if cl.entries[q])
            if used >= self.max_devices:
                # cap reached: an EMPTY row is one more device in use
                # the moment anything lands on it, so mask empty rows
                # from the sweep along with refusing the fresh fallback
                empty = np.fromiter((not cl.entries[q]
                                     for q in range(cl.d)),
                                    dtype=bool, count=cl.d)
                if empty.any():
                    feasible = feasible & ~empty
                    r_inter = np.where(empty, np.inf, r_inter)
        row = prov._argmin_inter(r_inter) if feasible.any() else -1
        if row == -1:
            if self.max_devices is not None:
                prov._check_device_cap(
                    sum(1 for q in range(cl.d) if cl.entries[q]),
                    self.max_devices, spec.name, self.hw)
            row = cl.add_device()
            self.row_gpus.append(self._next_gpu)
            self._next_gpu += 1
            cl.add_entry(row, spec, c, b,
                         prov.self_grant(spec, c, b, rl, self.hw,
                                         budget=cl.bm))
        else:
            cl.set_row_r(row, rr[row])
            cl.add_entry(row, spec, c, b, float(rn[row]))
        self.home[spec.name] = row

    def _theorem1(self, spec: WorkloadSpec, c: WorkloadCoefficients,
                  batch: str) -> tuple:
        """(b_appr, r_lower) through the shared probe cache when one is
        attached — repeat edits to a (spec, budget) pair skip the
        joint-batch scan entirely."""
        if self.probes is not None:
            return self.probes.theorem1(spec, c, self.hw, self.cl.bm, batch)
        b = prov.appropriate_batch(spec, c, self.hw, budget=self.cl.bm,
                                   batch=batch)
        rl = prov.resource_lower_bound(spec, c, self.hw, b,
                                       budget=self.cl.bm)
        return b, rl

    def add(self, spec: WorkloadSpec, *, batch: str = "joint",
            pin: Optional[tuple] = None) -> None:
        """``pin=(batch, r_floor)`` bypasses Theorem 1 — the health
        layer's capacity-preserving migration (`prov.add_workload`
        semantics)."""
        c = self.profiles[spec.model]
        if pin is not None:
            b, rl = int(pin[0]), float(pin[1])
        else:
            b, rl = self._theorem1(spec, c, batch)
        self._place(spec, c, b, rl)

    def resize(self, spec: WorkloadSpec, *, batch: str = "joint") -> None:
        """Theorem 1 at the new rate, same-device Alg. 2 re-run first,
        vectorized migration fallback (provisioner.resize_workload
        semantics, O(devices touched))."""
        c = self.profiles[spec.model]
        b, rl = self._theorem1(spec, c, batch)
        cl = self.cl
        q = self.home.pop(spec.name)
        cl.remove_entry(q, self._slot_at(q, spec.name))
        if self.row_gpus[q] in self.banned:
            # quarantined home device: no same-device fast path — the
            # resize IS the eviction (min-interference move elsewhere)
            self._place(spec, c, b, rl)
            return
        residents = [(s, cc, bb, float(cl.r[q, i]))
                     for i, (s, cc, bb) in enumerate(cl.entries[q])]
        r_a = pmv.alloc_gpus_vec(residents, spec, c, b, rl, self.hw,
                                 budget=cl.bm)
        if r_a is not None and self.shadow:
            resv_q = math.fsum(
                sr for n2, sr in self.shadow.items()
                if n2 != spec.name and self.home.get(n2) == q)
            if math.fsum(r_a) + resv_q > 1.0 + 1e-9:
                r_a = None           # the reservation holds: migrate
        if r_a is not None:
            cl.set_row_r(q, np.array(r_a[:-1]))
            cl.add_entry(q, spec, c, b, r_a[-1])
            self.home[spec.name] = q
        else:
            self._place(spec, c, b, rl)

    def to_plan(self) -> ProvisioningPlan:
        plan = ProvisioningPlan(hardware=self.hardware)
        cl = self.cl
        for q in range(cl.d):
            for i, (s, _, b) in enumerate(cl.entries[q]):
                plan.placements.append(Placement(
                    workload=s, gpu=self.row_gpus[q],
                    r=float(cl.r[q, i]), batch=b))
        plan.n_gpus = sum(1 for q in range(cl.d) if cl.entries[q])
        return plan


# ---------------------------------------------------------------------------
# Drift reconciliation over incremental plan edits
# ---------------------------------------------------------------------------

@dataclass
class PlanEdit:
    """One reconciliation action, recorded for telemetry/benchmarks."""
    t_s: float
    action: str        # "resize" | "remove" | "add" | "split" | "merge"
                       # | "infeasible" | "migrate" (health eviction)
                       # | "readmit" (workload = "device:<gpu>")
                       # | admission layer: "preempt" / "shed" (victim /
                       #   self parked under the cap), "admit" (shed
                       #   workload re-placed), "capped" (growth refused,
                       #   demand queues at the old allocation)
                       # | predictive tier: "forecast" (pre-size /
                       #   pre-split to the forecast rate; rate_to = the
                       #   sized target), "shadow_arm" / "shadow_disarm"
                       #   (Sec. 4.2 reservations granted / released;
                       #   replicas = instances touched)
    workload: str      # BASE workload name (replicas are one workload)
    rate_from: float
    rate_to: float
    burstiness: float
    replicas: int = 1  # replica count AFTER the edit (0 on remove)


class Reconciler:
    """Hysteresis-banded drift detection + incremental plan edits.

    Holds the CURRENT plan (starting from the provisioned one) and the
    per-workload target specs it was last reconciled to.  Each tick
    compares estimator state against those targets; a sustained breach
    (debounce) triggers `resize_workload` at the estimated rate (plus
    headroom on up-drift), departures (`remove_workload`) and
    re-arrivals (`add_workload`).  The queueing budget's burstiness is
    refreshed from the rate-weighted mean CV^2 estimate whenever edits
    are issued, so re-solved budgets track the measured arrival process.
    """

    def __init__(self, plan: ProvisioningPlan,
                 profiles: Dict[str, WorkloadCoefficients],
                 hw: HardwareSpec, *,
                 config: Optional[PlannerConfig] = None,
                 budget: Optional[BudgetLike] = None,
                 batch: Optional[str] = None,
                 engine: Optional[str] = None,
                 cfg: Optional[ControllerConfig] = None,
                 telemetry: Optional["telemetry_mod.Telemetry"] = None):
        self.plan = plan
        self.profiles = profiles
        self.hw = hw
        self.cfg = cfg or ControllerConfig()
        self.telemetry = telemetry
        # planner-knob resolution: config= > cfg.planner > the legacy
        # keywords over the controller's joint-batch default
        base = (self.cfg.planner if self.cfg.planner is not None
                else PlannerConfig(batch="joint", k_max=self.cfg.k_max))
        self.planner = planner_config(config, base=base, budget=budget,
                                      batch=batch, engine=engine)
        self.base_bm = resolve(self.planner.budget)
        self.bm = self.base_bm
        self.batch = self.planner.batch
        self.engine = self.planner.engine
        self.k_max = self.planner.k_max
        # the torch backend's device, resolved before the first tick: the
        # mirror is built lazily, but a run without CUDA must not start
        if self.planner.backend == "torch":
            resolve_device(self.planner.device)
        # one probe cache across ALL edits: repeat (spec, budget) probes
        # — the dominant cost of a reconciliation at large m — are O(1)
        self.probes = prov.ProbeCache()
        # engine="vec": lazily-built persistent VecCluster mirror (the
        # O(devices-touched) hot path); engine="scalar": each edit goes
        # through the plan-in/plan-out provisioner ops (the oracle)
        self._state: Optional[PlanState] = None
        self._state_bm = self.bm
        # targets are keyed by BASE workload name: a replica group is
        # reconciled as ONE workload whose target spec carries the full
        # (summed) rate; the plan holds the per-replica share specs
        self.targets: Dict[str, WorkloadSpec] = {}
        for base, group in replication.group_placements(
                plan.placements).items():
            spec0 = group[0].workload
            if len(group) == 1 and not replication.is_replica(spec0.name):
                self.targets[base] = spec0
            else:
                self.targets[base] = dataclasses.replace(
                    spec0, name=base,
                    rate_rps=sum(p.workload.rate_rps for p in group))
        self.departed: Dict[str, WorkloadSpec] = {}
        self.edits: List[PlanEdit] = []
        self._breach: Dict[str, tuple] = {}    # name -> (kind, streak)
        self._period_ms = 1000.0           # refreshed per reconcile call
        # health-layer quarantine: plan gpu ids banned from placement
        # (every edit path — evictions AND ordinary drift edits — avoids
        # them until readmission)
        self.quarantined: set = set()
        # admission layer (docs/control-plane.md, Overload): workloads
        # shed under the device cap, keyed by BASE name and holding the
        # TRUE target spec.  A shed workload's arrival stream stays
        # visible to its estimator (the simulator drops requests at the
        # instance, not the stream), so its silence on the SERVED side
        # is policy — never a departure — and readmission resumes from
        # live priors instead of re-bootstrapping from zero.
        self.max_devices = self.cfg.max_devices
        self.shed: Dict[str, WorkloadSpec] = {}
        self.brownout: Dict[str, float] = {}     # base -> working mult
        self._readmit_at: Dict[str, float] = {}  # base -> next retry t_s
        self.admission_log: List[tuple] = []     # (t_s, event, detail)
        self._adm = {"preempt": 0, "shed": 0, "readmit": 0, "capped": 0,
                     "brownout_ticks": 0, "brownout_max": 0}
        # predictive tier (cfg.forecast + docs/control-plane.md
        # Forecasting): armed Sec. 4.2 shadow reservations keyed by
        # PLACEMENT name.  Shared by reference with the vec mirror
        # (PlanState.shadow) so every edit path accounts for them; the
        # scalar oracle threads the same book through the provisioner
        # ops' ``reserved=`` map.  Also adopts simulator-armed
        # (shadow=True) reservations at the controller's first tick.
        self.armed: Dict[str, float] = {}
        self._fc_streak: Dict[str, int] = {}  # base -> breach streak
        self._fc_clear: Dict[str, int] = {}   # base -> breach-free ticks
        self._fc_edited: set = set()          # bases pre-sized THIS tick
        # bases with an ACTIVE shadow this tick (fed by the Controller):
        # an active reservation is never released mid-drain
        self.shadow_active_bases: set = set()

    # -- drift detection ----------------------------------------------------

    def _departed_now(self, name: str, est: ArrivalEstimator) -> bool:
        """A zero-arrival stretch long enough that the provisioned rate
        would have produced >= depart_missed arrivals: the workload left
        (much faster than waiting for the EWMA to decay to ~zero).
        Requires PRIOR activity — a workload that has never sent a
        request is "not started yet", not departed: reclaiming its
        capacity would manufacture a cold start the moment it begins."""
        return (est.ever_active
                and est.empty_ms * self._orig_rate(name) / 1000.0
                >= self.cfg.depart_missed)

    def _drift_kind(self, name: str, est: ArrivalEstimator) -> str:
        """"up" / "down" / "burst" / "" (in-band).

        The rate bands are widened to `noise_sigmas` sigmas of the
        smoothed Poisson counting noise, so low-rate workloads need a
        proportionally larger relative drift — that is what keeps a
        noise-only (constant-rate Poisson) run at zero reconfigurations.
        """
        cfg = self.cfg
        plan_rate = (self.targets[name].rate_rps
                     if name in self.targets else 0.0)
        if plan_rate <= 0.0:     # departed: any sustained rate re-adds it
            return "up" if (est.rate_rps
                            > cfg.depart_frac * self._orig_rate(name)
                            and est.empty_ms == 0.0) else ""
        if not est.ever_active:  # no traffic yet: the provisioned plan
            return ""            # is the best prior, leave it alone
        noise = cfg.noise_sigmas * est.rate_sigma() / plan_rate
        if est.projected_rps / plan_rate > 1.0 + max(cfg.band_up, noise):
            return "up"
        if (est.rate_rps / plan_rate < 1.0 - max(cfg.band_down, noise)
                or self._departed_now(name, est)):
            return "down"
        if (self.bm.mode == "queueing"
                and est.n_gaps >= cfg.min_gap_obs
                and est.cv2 > self.bm.burstiness + cfg.burst_band):
            return "burst"       # burstier than budgeted: tighten
        return ""

    def _orig_rate(self, name: str) -> float:
        spec = (self.targets.get(name) or self.departed.get(name)
                or self.shed.get(name))
        return max(spec.rate_rps, 1e-9) if spec is not None else 1e-9

    def _cluster_cv2(self, estimators: Dict[str, ArrivalEstimator]) -> float:
        """Rate-weighted mean CV^2 across workloads with enough data —
        the single `BudgetModel.burstiness` the budget split consumes."""
        num = den = 0.0
        for est in estimators.values():
            if est.n_gaps >= self.cfg.min_gap_obs:
                num += est.rate_rps * est.cv2
                den += est.rate_rps
        return num / den if den > 0.0 else self.bm.burstiness

    # -- reconciliation -----------------------------------------------------

    def reconcile(self, now_s: float,
                  estimators: Dict[str, ArrivalEstimator],
                  backlog: Optional[Dict[str, float]] = None,
                  period_ms: float = 1000.0) -> bool:
        """One control period: returns True when the plan changed.

        ``backlog`` maps workload -> queued requests at the tick (from
        the live instances); it feeds the resize target so recovering
        from an under-capacity stretch budgets DRAIN capacity, not just
        the go-forward arrival rate.
        """
        cfg = self.cfg
        self._period_ms = period_ms
        need = {"up": cfg.debounce_up, "down": cfg.debounce_down,
                "burst": cfg.debounce_burst}
        pending: List[str] = []
        for name, est in estimators.items():
            if name in self.shed:
                # admission-layer shed: the workload's silence on the
                # served side is POLICY, not drift or departure — the
                # readmission pass below owns its lifecycle
                continue
            kind = self._drift_kind(name, est)
            prev_kind, prev_n = self._breach.get(name, ("", 0))
            # kind-aware debounce: consecutive same-kind breaches;
            # a departure-length silence bypasses it (nothing noisy
            # about depart_missed expected arrivals not showing up)
            n = prev_n + 1 if kind and kind == prev_kind else (1 if kind
                                                               else 0)
            self._breach[name] = (kind, n)
            if kind and (n >= need[kind]
                         or (kind == "down"
                             and self._departed_now(name, est))):
                pending.append(name)
        changed = False
        if cfg.forecast:
            # proactive tier BEFORE the reactive pass: the rate signal
            # LEADS the p99 signal, and a forecast edit raises its
            # base's target so the reactive drift check below compares
            # against the post-edit plan — the two tiers cannot
            # double-fire on one signal in this order either, and the
            # forecast keeps its one-tick head start (a 2 s flash crowd
            # is over before a reactive resize lands)
            changed |= self._forecast_pass(now_s, estimators, backlog or {})
            if self._fc_edited:
                # a base the forecast just pre-sized must not ALSO fire
                # reactively this tick: its group was re-placed against
                # the raised target, so the reactive reading (and the
                # group snapshot it would edit) are both stale
                pending = [n for n in pending if n not in self._fc_edited]
                for n in self._fc_edited:
                    self._breach[n] = ("", 0)
        if pending or self.shed:
            if pending and self.base_bm.mode == "queueing":
                # online burstiness, FLOORED at the provisioned model's:
                # a deterministic trace's cv2 ~ 0 must not loosen budgets
                # mid-drift (tail slack is what absorbs the transition),
                # while a spike train's cv2 >> 1 tightens them
                self.bm = self.base_bm.with_burstiness(
                    max(self._cluster_cv2(estimators),
                        self.base_bm.burstiness))
            self._ensure_state()
            if self.shed:
                changed |= self._readmit_shed(now_s, estimators)
            backlog = backlog or {}
            for name in pending:
                if name in self.shed:
                    # preempted by an EARLIER edit this same tick (its
                    # drift breach predates the preemption decision)
                    self._breach[name] = ("", 0)
                    continue
                est = estimators[name]
                changed |= self._apply(now_s, name, est,
                                       backlog.get(name, 0.0))
                self._breach[name] = ("", 0)
        # per-tick brownout depth record (admission telemetry): only
        # while the admission layer is active, so a cap-slack run's log
        # stays empty and its output byte-identical to pre-overload
        depth = len(self.brownout)
        if depth or self.shed:
            self.admission_log.append((now_s, "tick", depth))
        if depth:
            self._adm["brownout_ticks"] += 1
            self._adm["brownout_max"] = max(self._adm["brownout_max"],
                                            depth)
        if changed and self._state is not None:
            self.plan = self._state.to_plan()
        return changed

    def _ensure_state(self) -> None:
        """Lazily build / budget-sync the persistent VecCluster mirror
        (engine="vec" only; the scalar oracle edits plan-in/plan-out)."""
        if self.engine != "vec":
            return
        if self._state is None:
            self._state = PlanState(self.plan, self.profiles, self.hw,
                                    budget=self.bm,
                                    backend=self.planner.backend,
                                    device=self.planner.device,
                                    probes=self.probes,
                                    max_devices=self.max_devices,
                                    shadow=self.armed)
            self._state_bm = self.bm
            self._state.banned = set(self.quarantined)
        elif self.bm != self._state_bm:
            self._state.set_budget(self.bm)
            self._state_bm = self.bm

    # -- health-layer actions (quarantine / evict / readmit) ----------------

    def quarantine(self, gpus) -> None:
        """Ban devices from every placement path until readmission."""
        self.quarantined.update(int(g) for g in gpus)
        if self._state is not None:
            self._state.banned = set(self.quarantined)

    def readmit(self, now_s: float, gpus) -> None:
        """Lift the ban (probation expired); recorded as edits."""
        for g in gpus:
            self.quarantined.discard(int(g))
            self.edits.append(PlanEdit(now_s, "readmit", f"device:{g}",
                                       0.0, 0.0, self.bm.burstiness, 0))
        if self._state is not None:
            self._state.banned = set(self.quarantined)

    def _fitted_util(self, p: Placement) -> float:
        """Fitted-model utilization of one placement in isolation:
        rate x predicted t_inf(batch, r) / (1000 x batch).  Ignoring
        co-resident interference under-estimates — the residual guard
        in the eviction split decision covers both gaps."""
        c = self.profiles[p.workload.model]
        t = pm.predict_device(
            [pm.PlacedWorkload(coeffs=c, batch=p.batch, r=p.r)],
            self.hw).per_workload[0].t_inf
        return p.workload.rate_rps * t / (1000.0 * p.batch)

    def evict(self, now_s: float) -> bool:
        """Migrate every live-rate placement off quarantined devices to
        min-interference homes elsewhere.  Two shapes per victim group:

        * capacity-preserving move — the placement is re-homed with its
          planned ``(batch, r)`` PINNED (banned `alloc_all` sweep with
          the fresh-device fallback), never re-derived: the budget may
          have drifted since provisioning (measured burstiness refresh),
          and re-running Theorem 1 at eviction time can hand a heavy
          victim a smaller batch than it was provisioned with — small
          enough to push its TRUE utilization past 1 on any device.
        * drain split — a victim pinned at its throughput ceiling can
          never drain the backlog it accumulated during detection
          latency (headroom ~0).  When the group's worst fitted
          utilization x `health_residual_guard` exceeds
          `health_drain_util`, the whole group is re-placed as enough
          equal-share replicas — each pinned at the group's planned
          capacity point — to put every member under that target,
          buying the drain real headroom.

        Zero-share parked replicas stay put: there is no traffic to
        save."""
        cfg = self.cfg
        bad = self.quarantined
        if not bad:
            return False
        victims = [p for p in self.plan.placements
                   if p.gpu in bad and p.workload.rate_rps > 0.0]
        if not victims:
            return False
        self._ensure_state()
        by_base: Dict[str, List[Placement]] = {}
        for p in victims:
            by_base.setdefault(replication.base_name(p.workload.name),
                               []).append(p)
        for base in sorted(by_base):
            rate = sum(p.workload.rate_rps for p in by_base[base])
            group = self._group(base)
            c = self.profiles[by_base[base][0].workload.model]
            k_cur = max(1, len(group))
            k_new = k_cur
            if self.k_max > 1:
                util = max(self._fitted_util(p) for p in group) \
                    * cfg.health_residual_guard
                if util > cfg.health_drain_util:
                    k_new = min(self.k_max,
                                max(k_cur + 1,
                                    math.ceil(k_cur * util
                                              / cfg.health_drain_util)))
            plan0 = self._checkpoint()
            try:
                if k_new > k_cur:
                    total = replication.group_rate(
                        [p.workload for p in group])
                    proto = dataclasses.replace(
                        by_base[base][0].workload, name=base,
                        rate_rps=total)
                    reps = replication.make_replicas(proto, k_new)
                    # pin every replica at the group's planned capacity
                    # point (heaviest member's batch and grant): per-
                    # replica serving capacity is preserved while the
                    # rate share drops 1/k — that gap IS the drain
                    # headroom.  A re-derived Theorem 1 placement at the
                    # share rate would hand back a minimum-capacity
                    # allocation instead, and minimum capacity is
                    # exactly what cannot drain.
                    pin = max(((p.batch, p.r) for p in group),
                              key=lambda t: (t[0], t[1]))
                    for p in group:
                        self._remove_name(p.workload.name)
                    for rs in reps:
                        self._add_spec(rs, pin=pin)
                else:
                    for p in by_base[base]:
                        self._remove_name(p.workload.name)
                        self._add_spec(p.workload, pin=(p.batch, p.r))
            except prov.DeviceCapError:
                # the cap refuses the re-home: leave the victim on the
                # quarantined device (honest degraded state) rather
                # than half-moving its group
                self._restore(plan0)
                self._adm["capped"] += 1
                self.admission_log.append((now_s, "capped", base))
                continue
            self.edits.append(PlanEdit(
                now_s, "migrate", base, rate, rate,
                self.bm.burstiness, k_new))
        if self._state is not None:
            self.plan = self._state.to_plan()
        return True

    # -- plan-edit plumbing (replica-aware) ---------------------------------

    def _group(self, base: str) -> List[Placement]:
        """Current replica placements of one base workload.

        A direct prefix scan rather than `replication.group_placements`:
        rebuilding the FULL plan's group index per edit was a dominant
        controller-overhead term at m=1000 (one O(plan) dict build and
        per-group sort per probe).  Same membership and replica order —
        replica names are exactly ``base + SEP + int``.
        """
        pref = base + replication.SEP
        group = [p for p in self.plan.placements
                 if p.workload.name == base
                 or p.workload.name.startswith(pref)]
        group.sort(key=lambda p: replication.replica_index(
            p.workload.name) or 0)
        return group

    def _reserved_map(self) -> Optional[Dict[int, float]]:
        """Plan-gpu -> armed shadow reservation, for the scalar
        provisioner ops (the vec mirror reads the shared book
        directly).  None while nothing is armed — the historical
        call signature, byte-identical behavior."""
        if not self.armed:
            return None
        by_name = {p.workload.name: p.gpu for p in self.plan.placements}
        gpus: Dict[int, float] = {}
        for name, sr in self.armed.items():
            g = by_name.get(name)
            if g is not None:
                gpus[g] = gpus.get(g, 0.0) + sr
        return gpus or None

    def _remove_name(self, name: str) -> None:
        # a removed placement's reservation leaves with it: reservations
        # are valid only for the placement they were computed against
        self.armed.pop(name, None)
        if self._state is not None:
            self._state.remove(name)
            if self.telemetry is not None:
                self.telemetry.count("prov_remove")
        else:
            self.plan = prov.remove_workload(self.plan, name,
                                             telemetry=self.telemetry)

    def _add_spec(self, spec: WorkloadSpec,
                  pin: Optional[tuple] = None) -> None:
        if self._state is not None:
            self._state.add(spec, batch=self.batch, pin=pin)
            if self.telemetry is not None:
                self.telemetry.count("prov_add")
        else:
            self.plan = prov.add_workload(
                self.plan, spec, self.profiles, self.hw,
                config=self.planner.replace(budget=self.bm),
                exclude_gpus=frozenset(self.quarantined) or None,
                pin=pin, max_devices=self.max_devices,
                reserved=self._reserved_map(),
                telemetry=self.telemetry)

    def _resize_spec(self, spec: WorkloadSpec) -> None:
        # the resized placement's own reservation was computed against
        # its OLD allocation: drop it (the forecast pass re-arms against
        # the new one on its next breach tick)
        self.armed.pop(spec.name, None)
        if self._state is not None:
            self._state.resize(spec, batch=self.batch)
            if self.telemetry is not None:
                self.telemetry.count("prov_resize")
        else:
            self.plan = prov.resize_workload(
                self.plan, spec, self.profiles, self.hw,
                config=self.planner.replace(budget=self.bm),
                max_devices=self.max_devices,
                reserved=self._reserved_map(),
                telemetry=self.telemetry)

    def _validate(self, reps: List[WorkloadSpec],
                  c: WorkloadCoefficients) -> bool:
        """Pre-flight Theorem 1 on every replica spec so a multi-replica
        edit either applies atomically or not at all (a mid-loop
        InfeasibleError would leave the group half-edited)."""
        try:
            for rs in reps:
                self.probes.theorem1(rs, c, self.hw, self.bm, self.batch)
        except prov.InfeasibleError:
            return False
        return True

    def _apply(self, now_s: float, name: str, est: ArrivalEstimator,
               backlog: float) -> bool:
        cfg = self.cfg
        cur = self.targets.get(name)
        orig = cur if cur is not None else self.departed[name]
        plan_rate = cur.rate_rps if cur is not None else 0.0
        group = self._group(name)
        k_cur = len(group)

        # departure: sustained near-zero rate or a long-enough silence
        if cur is not None and (
                est.rate_rps < cfg.depart_frac * self._orig_rate(name)
                or self._departed_now(name, est)):
            for p in group:
                self._remove_name(p.workload.name)
            self.departed[name] = cur
            del self.targets[name]
            self.edits.append(PlanEdit(now_s, "remove", name,
                                       plan_rate, 0.0, self.bm.burstiness,
                                       0))
            return True

        new_rate = est.rate_rps
        if est.projected_rps > plan_rate:   # up-drift: lead the ramp and
            new_rate = est.projected_rps * (1.0 + cfg.headroom)
            # budget capacity to drain the accumulated backlog within
            # ~one control period (capped so a transient spike cannot
            # demand an absurd allocation)
            drain = min(backlog * 1000.0 / max(self._period_ms, 1e-9),
                        cfg.drain_cap * est.rate_rps)
            new_rate += drain
        new_spec = dataclasses.replace(orig, name=name, rate_rps=new_rate)
        c = self.profiles[orig.model]
        # scale-out/scale-in decision: the smallest solo-feasible replica
        # count at the new rate (None = hopeless at ANY k).  Up-drift
        # never merges in the same edit (freeing capacity mid-ramp is
        # the expensive error — scale-in rides the slow, debounced down
        # path like any release), and a hopeless workload KEEPS its
        # current membership: merging a working group down to one
        # guaranteed-violating instance would destroy capacity the
        # residual still uses.
        k_need = self.probes.required_replicas(new_spec, c, self.hw,
                                               self.bm, self.batch,
                                               k_max=self.k_max) \
            if self.k_max > 1 else 1
        updrift = est.projected_rps > plan_rate
        try:
            action, k_new = self._edit(name, new_spec, c, k_need,
                                       cur, group, k_cur, updrift)
        except prov.DeviceCapError:
            # the fleet cap — not physics — refused the edit: route the
            # demand through the admission layer (preempt -> brownout ->
            # queue-or-shed) instead of reporting it infeasible
            return self._overloaded(now_s, name, new_spec, c, k_need,
                                    cur, group, k_cur, updrift,
                                    plan_rate)
        except prov.InfeasibleError:
            # beyond any feasible allocation even split k_max ways:
            # keep the current placement, report honestly via the edits
            self.edits.append(PlanEdit(now_s, "infeasible", name,
                                       plan_rate, new_rate,
                                       self.bm.burstiness, k_cur))
            return False
        self.brownout.pop(name, None)    # a true-SLO edit landed:
        self.targets[name] = new_spec    # the brownout has recovered
        self.edits.append(PlanEdit(now_s, action, name, plan_rate,
                                   new_rate, self.bm.burstiness, k_new))
        return True

    # -- transactional edit application -------------------------------------

    def _checkpoint(self) -> tuple:
        """Materialized recovery point for a multi-op edit sequence: the
        device cap can fire MID-sequence (the Theorem-1 pre-flight cannot
        see placement-time cap pressure), and both engine paths must roll
        back to exactly this plan.  The armed shadow book rides along —
        an edit that dropped or granted reservations before failing must
        hand them back too (tests/test_forecast.py injects exactly
        that failure)."""
        plan = self._state.to_plan() if self._state is not None \
            else self.plan
        return plan, dict(self.armed)

    def _restore(self, cp: tuple) -> None:
        """Roll back to checkpoint ``cp``.  The scalar path re-adopts the
        plan directly (the provisioner ops are plan-in/plan-out); the vec
        mirror is discarded and rebuilt from it — the rebuild's
        gpu-sorted row order matches what the incremental history
        produced, so every subsequent allocation stays identical to the
        scalar oracle's.  The armed book is restored IN PLACE: the
        rebuilt mirror shares the same dict."""
        plan0, armed0 = cp
        self.plan = plan0
        self.armed.clear()
        self.armed.update(armed0)
        if self._state is not None:
            self._state = None
            self._ensure_state()

    def _edit(self, name: str, new_spec: WorkloadSpec,
              c: WorkloadCoefficients, k_need: Optional[int],
              cur: Optional[WorkloadSpec], group: List[Placement],
              k_cur: int, updrift: bool) -> tuple:
        """Apply one workload's plan edit atomically; returns
        ``(action, k_new)`` or raises (`DeviceCapError` /
        `InfeasibleError`) with the plan rolled back to its pre-edit
        state."""
        if cur is None:               # re-arrival of a departed workload
            reps = replication.make_replicas(new_spec, k_need or 1)
            if len(reps) > 1 and not self._validate(reps, c):
                raise prov.InfeasibleError(name)
            plan0 = self._checkpoint()
            try:
                for rs in reps:
                    self._add_spec(rs)
            except prov.InfeasibleError:
                self._restore(plan0)
                raise
            del self.departed[name]
            return "add", len(reps)
        if k_need is None:
            k_new = max(k_cur, 1)        # hopeless: keep membership
        elif updrift:
            k_new = max(k_cur, k_need)
        else:
            k_new = k_need
        k_new = max(1, min(k_new, self.k_max))
        reps = replication.make_replicas(new_spec, k_new)
        same = [r.name for r in reps] == [p.workload.name
                                          for p in group]
        # pre-flight anything non-atomic: a membership change mutates
        # the plan across several remove/add calls, and a multi-replica
        # resize across several resize calls — a mid-loop physics raise
        # would leave the group half-edited (the checkpoint additionally
        # covers cap errors, which no pre-flight can rule out)
        if (not same or len(reps) > 1) and not self._validate(reps, c):
            raise prov.InfeasibleError(name)
        plan0 = self._checkpoint()
        try:
            if same:
                # same membership: per-replica same-device resize
                for rs in reps:
                    self._resize_spec(rs)
                return "resize", k_new
            # membership changes: re-place the whole group (the
            # removed rate shares renormalize over the new k)
            for p in group:
                self._remove_name(p.workload.name)
            for rs in reps:
                self._add_spec(rs)
            return ("split" if k_new > k_cur else "merge"), k_new
        except prov.InfeasibleError:
            self._restore(plan0)
            raise

    # -- admission layer (device cap: preempt / brownout / shed) ------------

    def _shed_base(self, now_s: float, base: str, action: str) -> None:
        """Park one base workload under the cap: its placements leave
        the plan (freeing allocation), its target moves to ``shed``, and
        `Controller._apply_plan` marks its instances shed so the
        simulator drops (and counts) their requests."""
        for p in self._group(base):
            self._remove_name(p.workload.name)
        spec = self.targets.pop(base)
        self.shed[base] = spec
        self._readmit_at[base] = now_s + self.cfg.readmit_backoff_s
        self.brownout.pop(base, None)
        self._adm["preempt" if action == "preempt" else "shed"] += 1
        self.admission_log.append((now_s, action, base))
        self.edits.append(PlanEdit(now_s, action, base, spec.rate_rps,
                                   0.0, self.bm.burstiness, 0))

    def _overloaded(self, now_s: float, name: str,
                    new_spec: WorkloadSpec, c: WorkloadCoefficients,
                    k_need: Optional[int], cur: Optional[WorkloadSpec],
                    group: List[Placement], k_cur: int, updrift: bool,
                    plan_rate: float) -> bool:
        """The device cap refused ``name``'s edit.  In order: preempt
        strictly-lower-priority groups (worst footprint first, the
        `replication.preemption_order`), then retry under a brownout
        (loosened WORKING SLO shrinks the demand), then queue-or-shed.
        Every decision lands in ``admission_log`` and ``edits``."""
        cfg = self.cfg
        pr = int(new_spec.priority)
        # 1) preemption: shed cheaper classes until the grant fits or
        # victims run out (the order is priority-ascending, so the first
        # victim at or above our class ends the hunt)
        groups = replication.group_placements(self.plan.placements)
        for victim in replication.preemption_order(groups):
            if victim == name or victim not in self.targets:
                continue
            if replication.group_priority(groups[victim]) >= pr:
                break
            self._shed_base(now_s, victim, "preempt")
            try:
                action, k_new = self._edit(name, new_spec, c, k_need,
                                           cur, group, k_cur, updrift)
            except prov.DeviceCapError:
                continue              # freed too little: next victim
            except prov.InfeasibleError:
                break                 # physics says no: stop shedding
            self.brownout.pop(name, None)
            self.targets[name] = new_spec
            self.edits.append(PlanEdit(now_s, action, name, plan_rate,
                                       new_spec.rate_rps,
                                       self.bm.burstiness, k_new))
            return True
        # 2) brownout: retry with a loosened WORKING SLO.  The target
        # keeps the true SLO — every later breach retries recovery, and
        # per-class accounting measures against ``slo0`` — so this only
        # changes what the planner is asked for, never what is reported.
        if cfg.brownout_mult > 1.0:
            loose = dataclasses.replace(
                new_spec, slo_ms=new_spec.slo_ms * cfg.brownout_mult)
            k_loose = self.probes.required_replicas(
                loose, c, self.hw, self.bm, self.batch,
                k_max=self.k_max) if self.k_max > 1 else 1
            try:
                action, k_new = self._edit(name, loose, c, k_loose,
                                           cur, group, k_cur, updrift)
            except prov.InfeasibleError:
                action = ""
            if action:
                self.brownout[name] = cfg.brownout_mult
                self.targets[name] = new_spec
                self.admission_log.append((now_s, "brownout", name))
                self.edits.append(PlanEdit(now_s, action, name,
                                           plan_rate, new_spec.rate_rps,
                                           self.bm.burstiness, k_new))
                return True
        # 3) queue-or-shed: a workload still holding capacity KEEPS it
        # and queues (the cap refused growth, not service); a re-arrival
        # with nothing placed is shed outright until capacity frees
        self._adm["capped"] += 1
        self.admission_log.append((now_s, "capped", name))
        if cur is not None:
            self.edits.append(PlanEdit(now_s, "capped", name, plan_rate,
                                       new_spec.rate_rps,
                                       self.bm.burstiness, k_cur))
            return False
        del self.departed[name]
        self.shed[name] = dataclasses.replace(new_spec,
                                              rate_rps=plan_rate
                                              if plan_rate > 0.0
                                              else new_spec.rate_rps)
        self._readmit_at[name] = now_s + cfg.readmit_backoff_s
        self._adm["shed"] += 1
        self.edits.append(PlanEdit(now_s, "shed", name, 0.0,
                                   new_spec.rate_rps,
                                   self.bm.burstiness, 0))
        return True

    def _readmit_shed(self, now_s: float,
                      estimators: Dict[str, "ArrivalEstimator"]) -> bool:
        """Per-tick readmission pass, highest priority first.  A shed
        workload whose demand ACTUALLY left (the estimator still sees
        its arrival stream) moves to the ordinary departure book; the
        rest retry placement under the cap with exponential-free backoff
        (`readmit_backoff_s`), resuming from live estimator priors."""
        changed = False
        for base in sorted(self.shed,
                           key=lambda b: (-self.shed[b].priority, b)):
            est = estimators.get(base)
            if est is not None and self._departed_now(base, est):
                self.departed[base] = self.shed.pop(base)
                self._readmit_at.pop(base, None)
                self.admission_log.append((now_s, "shed-departed", base))
                self.edits.append(PlanEdit(now_s, "remove", base, 0.0,
                                           0.0, self.bm.burstiness, 0))
                continue
            if now_s < self._readmit_at.get(base, 0.0):
                continue
            spec0 = self.shed[base]
            rate = spec0.rate_rps
            if est is not None and est.ever_active:
                rate = max(est.rate_rps, est.projected_rps)
            trial = dataclasses.replace(spec0, rate_rps=rate)
            c = self.profiles[spec0.model]
            k = self.probes.required_replicas(trial, c, self.hw, self.bm,
                                              self.batch,
                                              k_max=self.k_max) \
                if self.k_max > 1 else 1
            try:
                reps = replication.make_replicas(trial, k or 1)
                if not self._validate(reps, c):
                    raise prov.InfeasibleError(base)
                plan0 = self._checkpoint()
                try:
                    for rs in reps:
                        self._add_spec(rs)
                except prov.InfeasibleError:
                    self._restore(plan0)
                    raise
            except prov.InfeasibleError:
                # still capped (or still infeasible): back off and retry
                self._readmit_at[base] = now_s \
                    + self.cfg.readmit_backoff_s
                continue
            del self.shed[base]
            self._readmit_at.pop(base, None)
            self.targets[base] = trial
            self._adm["readmit"] += 1
            self.admission_log.append((now_s, "readmit", base))
            self.edits.append(PlanEdit(now_s, "admit", base, 0.0, rate,
                                       self.bm.burstiness, len(reps)))
            changed = True
        return changed

    # -- predictive tier (forecast-armed Sec. 4.2 shadows) -------------------

    def _armed_names(self, base: str) -> List[str]:
        pref = base + replication.SEP
        return [n for n in self.armed
                if n == base or n.startswith(pref)]

    def _forecast_pass(self, now_s: float,
                       estimators: Dict[str, ArrivalEstimator],
                       backlog: Dict[str, float]) -> bool:
        """One tick of the proactive tier: per base workload, compare the
        horizon forecast against the plan target behind its own
        (noise-widened, debounced) band; a sustained breach pre-sizes /
        pre-splits the group to the forecast rate AND arms Sec. 4.2
        shadows on its devices, both through the same transactional edit
        machinery as reactive drift.  Runs BEFORE the reactive pass — the
        rate signal leads the p99 signal, and a forecast edit raises the
        target the reactive drift check is then re-evaluated against, so
        the two tiers never double-fire on one signal.  Breach-free
        for `forecast_hold` ticks releases a base's reservations, unless
        one is ACTIVE (the Controller feeds ``shadow_active_bases``)."""
        cfg = self.cfg
        changed = False
        acted_any = False
        self._fc_edited.clear()
        for base in sorted(self.targets):
            est = estimators.get(base)
            cur = self.targets[base]
            if est is None or not est.ever_active or cur.rate_rps <= 0.0:
                continue
            plan_rate = cur.rate_rps
            f = est.forecast_rps(cfg.forecast_horizon)
            band = max(cfg.forecast_band,
                       cfg.forecast_sigmas * est.rate_sigma() / plan_rate)
            if f / plan_rate > 1.0 + band:
                self._fc_clear[base] = 0
                streak = self._fc_streak.get(base, 0) + 1
                self._fc_streak[base] = streak
                if streak >= cfg.forecast_debounce:
                    if (not acted_any
                            and self.base_bm.mode == "queueing"):
                        # same online-burstiness tightening the reactive
                        # pass applies before its edits: a spike train's
                        # cv^2 >> 1 must tighten the forecast pre-size's
                        # budgets too (floored at the provisioned model)
                        self.bm = self.base_bm.with_burstiness(
                            max(self._cluster_cv2(estimators),
                                self.base_bm.burstiness))
                    acted_any = True
                    changed |= self._forecast_act(
                        now_s, base, est, f, backlog.get(base, 0.0))
            else:
                self._fc_streak[base] = 0
                if self._armed_names(base):
                    clear = self._fc_clear.get(base, 0) + 1
                    self._fc_clear[base] = clear
                    if (clear >= cfg.forecast_hold
                            and base not in self.shadow_active_bases):
                        changed |= self._disarm(now_s, base)
        return changed

    def _forecast_act(self, now_s: float, base: str,
                      est: ArrivalEstimator, f: float,
                      backlog: float = 0.0) -> bool:
        """Act on a debounced forecast breach: pre-size (and pre-split,
        when `required_replicas` says the forecast rate needs it) the
        group to the forecast target, then arm shadows on every device
        the group lands on.  A cap- or physics-refused pre-size still
        arms — the reservation costs nothing until activation and is the
        cheaper half of the insurance.  The proactive tier never invokes
        the admission layer: preempting live workloads on a prediction
        is the wrong trade."""
        cfg = self.cfg
        self._ensure_state()      # lazy: only a tick that ACTS builds
        cur = self.targets[base]  # the vec mirror
        plan_rate = cur.rate_rps
        c = self.profiles[cur.model]
        # same sizing rule as the reactive up-drift path, driven by the
        # HORIZON forecast instead of the one-period projection: lead
        # the ramp, plus capacity to drain the backlog the spike has
        # already queued within ~one control period (capped)
        target = max(f, est.projected_rps) * (1.0 + cfg.headroom)
        target += min(backlog * 1000.0 / max(self._period_ms, 1e-9),
                      cfg.drain_cap * est.rate_rps)
        new_spec = dataclasses.replace(cur, name=base, rate_rps=target)
        group = self._group(base)
        k_cur = len(group)
        k_need = self.probes.required_replicas(
            new_spec, c, self.hw, self.bm, self.batch,
            k_max=self.k_max) if self.k_max > 1 else 1
        changed = False
        try:
            action, k_new = self._edit(base, new_spec, c, k_need, cur,
                                       group, k_cur, True)
        except (prov.DeviceCapError, prov.InfeasibleError):
            action, k_new = "", k_cur
        if action:
            self.targets[base] = new_spec
            self._fc_edited.add(base)
            self.edits.append(PlanEdit(now_s, "forecast", base,
                                       plan_rate, target,
                                       self.bm.burstiness, k_new))
            changed = True
        changed |= self._arm_shadows(now_s, base, plan_rate, f)
        if changed:
            self._fc_streak[base] = 0
        return changed

    def _device_used(self, gpu: int, q: Optional[int]) -> float:
        """Live r committed on one device (exactly-rounded fsum, so the
        vec mirror and the scalar plan agree bit-for-bit regardless of
        summation order), plus every armed reservation homed there."""
        if self._state is not None and q is not None:
            st = self._state
            used = math.fsum(float(st.cl.r[q, i])
                             for i in range(len(st.cl.entries[q])))
            resv = math.fsum(sr for n, sr in self.armed.items()
                             if st.home.get(n) == q)
        else:
            used = math.fsum(p.r for p in self.plan.placements
                             if p.gpu == gpu)
            by_name = {p.workload.name: p.gpu
                       for p in self.plan.placements}
            resv = math.fsum(sr for n, sr in self.armed.items()
                             if by_name.get(n) == gpu)
        return used + resv

    def _arm_shadows(self, now_s: float, base: str, plan_rate: float,
                     f: float) -> bool:
        """Reserve Sec. 4.2 shadow capacity (`shadow_extra`, capped by
        the device's free share) for every replica of ``base`` that does
        not already hold one.  Arming only writes the book — the
        Controller maps it onto ``inst.shadow_r`` and the simulator's
        monitor tick activates it the moment the window p99 breaches the
        SLO, well inside the adjust period a reactive resize waits for."""
        cfg = self.cfg
        st = self._state
        armed_any = False
        if st is not None:
            pref = base + replication.SEP
            members = sorted(
                (n for n in st.home if n == base or n.startswith(pref)),
                key=lambda n: replication.replica_index(n) or 0)
            homes = [(n, st.row_gpus[st.home[n]], st.home[n])
                     for n in members]
        else:
            homes = [(p.workload.name, p.gpu, None)
                     for p in self._group(base)]
        for name, gpu, q in homes:
            if self.armed.get(name, 0.0) > 0.0:
                continue
            free_r = 1.0 - self._device_used(gpu, q)
            sr = min(cfg.shadow_extra, max(0.0, free_r))
            if sr <= 1e-12:
                continue
            self.armed[name] = sr
            armed_any = True
        if armed_any:
            self.edits.append(PlanEdit(now_s, "shadow_arm", base,
                                       plan_rate, f, self.bm.burstiness,
                                       len(homes)))
        return armed_any

    def _disarm(self, now_s: float, base: str) -> bool:
        """Release ``base``'s reservations (forecast clear for
        `forecast_hold` ticks, none active): the freed capacity returns
        to the placement sweeps and the Controller zeroes the live
        instances' ``shadow_r`` on apply."""
        names = self._armed_names(base)
        if not names:
            return False
        for n in names:
            del self.armed[n]
        self._fc_clear[base] = 0
        rate = self.targets[base].rate_rps if base in self.targets \
            else 0.0
        self.edits.append(PlanEdit(now_s, "shadow_disarm", base, rate,
                                   rate, self.bm.burstiness, len(names)))
        return True

    def overload_stats(self) -> Dict[str, float]:
        """Admission-layer counters for `SimResult.stats` — EMPTY until
        the first admission decision, which is what keeps a cap-slack
        run's stats byte-identical to the pre-overload build."""
        a = self._adm
        if not (a["preempt"] or a["shed"] or a["readmit"] or a["capped"]
                or a["brownout_ticks"]):
            return {}
        return {
            "overload_active": 1.0,
            "admission_preemptions": float(a["preempt"]),
            "admission_shed_workloads": float(a["shed"]),
            "admission_readmits": float(a["readmit"]),
            "admission_capped_edits": float(a["capped"]),
            "brownout_ticks": float(a["brownout_ticks"]),
            "brownout_depth_max": float(a["brownout_max"]),
            "shed_workloads_final": float(len(self.shed)),
        }


# ---------------------------------------------------------------------------
# The adjust_fn adapter
# ---------------------------------------------------------------------------

class Controller:
    """Closed-loop controller: pass as ``adjust_fn`` with
    ``adjust_scope="cluster"`` (it needs the whole cluster per tick).

    Wiring::

        ctl = Controller(plan, profiles, hw)
        res = simulate_plan(plan, models, hw, trace=trace,
                            adjust_fn=ctl, adjust_scope="cluster",
                            adjust_period_s=1.0)

    Stateful: construct a fresh instance per simulation run.  The
    reconciled plan is ``ctl.plan``; reconfiguration counts/latency land
    in ``SimResult.stats`` (``n_reconfigs`` / ``reconfig_latency_ms``).
    """

    def __init__(self, plan: ProvisioningPlan,
                 profiles: Dict[str, WorkloadCoefficients],
                 hw: HardwareSpec, *,
                 config: Optional[PlannerConfig] = None,
                 budget: Optional[BudgetLike] = None,
                 batch: Optional[str] = None,
                 engine: Optional[str] = None,
                 cfg: Optional[ControllerConfig] = None,
                 telemetry: Optional["telemetry_mod.Telemetry"] = None):
        self.cfg = cfg or ControllerConfig()
        self.telemetry = telemetry
        self.reconciler = Reconciler(plan, profiles, hw, config=config,
                                     budget=budget, batch=batch,
                                     engine=engine, cfg=self.cfg,
                                     telemetry=telemetry)
        bm = self.reconciler.base_bm
        # one estimator per BASE workload: replicas of one workload feed
        # a single merged arrival estimate (their slices partition the
        # pooled stream, so the merge IS the workload's arrival process)
        self.estimators: Dict[str, ArrivalEstimator] = {
            base: ArrivalEstimator(
                sum(p.workload.rate_rps for p in group), self.cfg,
                burstiness=bm.burstiness)
            for base, group in replication.group_placements(
                plan.placements).items()}
        self.health = (HealthMonitor(profiles, hw, self.cfg,
                                     telemetry=telemetry)
                       if self.cfg.health else None)
        self._canary = None
        self._last_s = 0.0
        self.n_ticks = 0
        # (t_s, $/h) after each tick: the cost the reconciled plan would
        # bill, so benchmarks can integrate savings from departures and
        # the price of ramp capacity over the run, not just endpoints.
        # Bounded ring (cfg.cost_retention newest rows; .total/.dropped
        # count overflow) — the unbounded list it replaces is still
        # readable through the deprecated `cost_series` property.
        self.costs = telemetry_mod.RingBuffer(self.cfg.cost_retention)

    @property
    def plan(self) -> ProvisioningPlan:
        return self.reconciler.plan

    @property
    def edits(self) -> List[PlanEdit]:
        return self.reconciler.edits

    @property
    def cost_series(self) -> List[tuple]:
        """Deprecated alias for ``list(self.costs)`` — the same
        (t_s, $/h) tuples the unbounded list used to hold, now capped
        at ``ControllerConfig.cost_retention`` rows."""
        warnings.warn(
            "Controller.cost_series is deprecated; read Controller.costs "
            "(a bounded telemetry.RingBuffer of the same tuples)",
            DeprecationWarning, stacklevel=2)
        return self.costs.list()

    def attach_canary(self, canary) -> None:
        """Simulator-installed health probe: ``canary(gpu, now_ms)``
        returns the device's CURRENT residual multiplier (``inf`` while
        down, 1.0 clean).  Consumed only at probation expiry — a real
        canary pass on an otherwise-empty device — so detection stays
        telemetry-driven while readmission becomes an active probe."""
        self._canary = canary

    def overload_stats(self) -> Dict[str, float]:
        """Admission-layer counters the simulator merges into
        `SimResult.stats`; empty until the first admission decision."""
        return self.reconciler.overload_stats()

    def __call__(self, now_s: float,
                 instances: List[ServedInstance]) -> None:
        if now_s == self._last_s and self.n_ticks > 0:
            # two calls at the same tick = the simulator is invoking us
            # once per device: estimators would see ~zero-width windows
            # and report garbage rates — fail loudly instead
            raise RuntimeError(
                "Controller needs the whole cluster per tick: pass "
                "adjust_scope=\"cluster\" to simulate_plan (the default "
                "\"device\" scope calls adjust_fn once per device)")
        if self.n_ticks == 0:
            # adopt simulator-armed (shadow=True) reservations into the
            # armed book, so every plan edit accounts for them — the
            # historical "Controller does not compose with shadow=True"
            # refusal is gone: the book makes reservations visible to
            # the placement sweeps in both engine paths
            for inst in instances:
                if inst.shadow_r > 0.0:
                    self.reconciler.armed.setdefault(
                        inst.spec.name, float(inst.shadow_r))
        window_ms = max((now_s - self._last_s) * 1000.0, 1e-9)
        tm = self.telemetry
        if tm is not None:
            # pre-edit placement snapshot + stream cursors, so every
            # decision this tick drains into an enriched ControlEvent
            t0 = _time.perf_counter()
            n_edits0 = len(self.reconciler.edits)
            n_adm0 = len(self.reconciler.admission_log)
            pre_map: Dict[str, List[tuple]] = {}
            for p in self.plan.placements:
                pre_map.setdefault(
                    replication.base_name(p.workload.name),
                    []).append((p.gpu, p.batch, p.r))
        backlog: Dict[str, float] = {}
        by_base: Dict[str, List[ServedInstance]] = {}
        for inst in instances:
            by_base.setdefault(replication.base_name(inst.spec.name),
                               []).append(inst)
        for base, insts_b in by_base.items():
            est = self.estimators.get(base)
            if est is None:       # instance outside the managed plan
                continue
            if len(insts_b) == 1:
                merged = insts_b[0].recent_arrivals
            else:
                # replica slices partition the pooled stream; their
                # sorted merge is the workload's arrival window
                merged = np.sort(np.concatenate(
                    [np.asarray(i.recent_arrivals) for i in insts_b]))
            est.observe(merged, window_ms)
            backlog[base] = float(sum(len(i.queue) for i in insts_b))
        # bases holding an ACTIVE shadow: the predictive tier's disarm
        # hold waits for these to deactivate before releasing capacity
        self.reconciler.shadow_active_bases = {
            base for base, insts_b in by_base.items()
            if any(i.shadow_active for i in insts_b)}
        changed = False
        rep = None
        if self.health is not None:
            rep = self.health.observe(now_s, instances,
                                      canary=self._canary)
        if tm is not None:
            # Sec. 5.5-style phase walls: probe = estimator + health
            # observation, solve = plan reconciliation, apply = mapping
            # the plan onto live instances
            t1 = _time.perf_counter()
            tm.add_wall("ctl_probe", (t1 - t0) * 1000.0)
        if rep is not None:
            if rep.readmit:
                for g in rep.readmit:
                    self.health.quarantined.pop(g, None)
                self.reconciler.readmit(now_s, rep.readmit)
            for g in rep.dead:
                self.health.quarantined[g] = ("failed", now_s)
            for g in rep.stragglers:
                self.health.quarantined[g] = ("straggler", now_s)
            if rep.dead or rep.stragglers:
                self.reconciler.quarantine(rep.dead + rep.stragglers)
                changed |= self.reconciler.evict(now_s)
        changed |= self.reconciler.reconcile(now_s, self.estimators,
                                             backlog, window_ms)
        solve_ms = 0.0
        if tm is not None:
            t2 = _time.perf_counter()
            solve_ms = (t2 - t1) * 1000.0
            tm.add_wall("ctl_solve", solve_ms)
        if changed:
            self._apply_plan(instances)
        if tm is not None:
            tm.add_wall("ctl_apply", (_time.perf_counter() - t2) * 1000.0)
            self._drain_events(now_s, rep, pre_map, n_edits0, n_adm0,
                               solve_ms)
            tm.gauge("probe_hits", self.reconciler.probes.hits)
            tm.gauge("probe_misses", self.reconciler.probes.misses)
        self._last_s = now_s
        self.n_ticks += 1
        self.costs.append((now_s, self.plan.cost_per_hour()))

    # decision kind -> the signal that drives it (docs/observability.md)
    _CAUSE = {"resize": "drift", "split": "drift", "merge": "drift",
              "infeasible": "drift", "migrate": "health",
              "readmit": "health", "preempt": "admission",
              "shed": "admission", "admit": "admission",
              "capped": "admission", "add": "arrival",
              "remove": "departure", "forecast": "forecast",
              "shadow_arm": "forecast", "shadow_disarm": "forecast"}

    def _drain_events(self, now_s: float, rep, pre_map, n_edits0: int,
                      n_adm0: int, solve_ms: float) -> None:
        """Turn this tick's decisions into typed `telemetry.ControlEvent`
        records: quarantine verdicts first (they precede reconciliation),
        then every new `PlanEdit` enriched with the driving estimator's
        state and the pre/post placement of the touched workload, then
        admission-log entries with no PlanEdit twin (brownout,
        shed-departed).  ``wall_ms`` on each event is the tick's solve
        wall — a host measurement, excluded from engine identity."""
        tm = self.telemetry
        cfg = self.cfg
        rec = self.reconciler
        if rep is not None:
            for kind_c, gpus in (("failed", rep.dead),
                                 ("straggler", rep.stragglers)):
                for g in gpus:
                    tm.record_event(telemetry_mod.ControlEvent(
                        t_s=now_s, kind="quarantine",
                        workload=f"device:{g}", cause=kind_c,
                        gpu_from=g, wall_ms=solve_ms))
        post_map: Dict[str, List[tuple]] = {}
        if len(rec.edits) > n_edits0:
            for p in self.plan.placements:
                post_map.setdefault(
                    replication.base_name(p.workload.name),
                    []).append((p.gpu, p.batch, p.r))
        for e in rec.edits[n_edits0:]:
            pre = pre_map.get(e.workload)
            post = post_map.get(e.workload)
            ev = telemetry_mod.ControlEvent(
                t_s=e.t_s, kind=e.action, workload=e.workload,
                cause=self._CAUSE.get(e.action, "drift"),
                rate_from=e.rate_from, rate_to=e.rate_to,
                burstiness=e.burstiness, replicas=e.replicas,
                pre=None if pre is None else tuple(pre),
                post=None if post is None else tuple(post),
                wall_ms=solve_ms)
            if pre is not None and post is not None \
                    and len(pre) == 1 and len(post) == 1:
                ev.gpu_from, ev.gpu_to = pre[0][0], post[0][0]
            est = self.estimators.get(e.workload)
            if est is not None:
                ev.rate_rps = est.rate_rps
                ev.trend_rps = est.trend_rps
                ev.cv2 = est.cv2
                ev.projected_rps = est.projected_rps
                ev.rate_sigma = est.rate_sigma()
                # the effective hysteresis bands at decision time: the
                # configured band widened to noise_sigmas sigmas of the
                # smoothed counting noise (see Reconciler._drift_kind)
                noise = (cfg.noise_sigmas * ev.rate_sigma / e.rate_from
                         if e.rate_from > 0.0 else 0.0)
                ev.band_up = max(cfg.band_up, noise)
                ev.band_down = max(cfg.band_down, noise)
            tm.record_event(ev)
        for (t_e, event, detail) in rec.admission_log[n_adm0:]:
            if event in ("brownout", "shed-departed"):
                tm.record_event(telemetry_mod.ControlEvent(
                    t_s=t_e, kind=event, workload=str(detail),
                    cause="admission", wall_ms=solve_ms))

    def _apply_plan(self, instances: List[ServedInstance]) -> None:
        """Map the reconciled plan onto the live instances: r / batch /
        gpu deltas the simulator turns into table rebuilds/migrations,
        plus the replica lifecycle —

          * a plan replica with no live instance first ADOPTS an
            unmatched instance of the same base workload (the first
            split renames the live ``w`` to ``w#0``; a merge-to-one
            renames ``w#0`` back to ``w``), else a fresh
            `ServedInstance` is APPENDED (the simulator wires its RNG
            streams and routes it a slice of the pooled arrivals);
          * a live replica the plan no longer names is PARKED at the
            allocation floor with a ZERO rate share, so the re-split
            routes it no further arrivals (it still drains its queue);
          * a departed workload's instances are parked as before
            (their arrivals have stopped; r_unit keeps physics valid).
        """
        by_name = {p.workload.name: p for p in self.plan.placements}
        plan_bases = {replication.base_name(n) for n in by_name}
        live_names = {inst.spec.name for inst in instances}
        armed = self.reconciler.armed
        free: Dict[str, List[ServedInstance]] = {}
        for inst in instances:
            name = inst.spec.name
            if name in by_name:
                p = by_name[name]
                inst.spec = p.workload        # refresh the rate share
                inst.r = p.r
                inst.batch = max(1, p.batch)
                inst.gpu = p.gpu
                inst.shed = False             # in the plan = admitted
                self._apply_shadow(inst, armed.get(name, 0.0))
                continue
            base = replication.base_name(name)
            if base in plan_bases:
                free.setdefault(base, []).append(inst)   # rename/park pool
            elif base in self.reconciler.shed:
                # admission-shed: park the allocation and mark the
                # instance so the simulator drops (and counts) its
                # requests.  The spec's rate SHARE stays — arrivals keep
                # routing here, so the estimator keeps seeing the true
                # demand and readmission resumes from live priors.
                inst.r = self.hw.r_unit
                inst.batch = 1
                inst.shed = True
                self._apply_shadow(inst, 0.0)
            elif base in self.reconciler.departed:
                inst.r = self.hw.r_unit
                inst.batch = 1
                self._apply_shadow(inst, 0.0)
        for p in self.plan.placements:        # plan order = replica order
            name = p.workload.name
            if name in live_names:
                continue
            base = replication.base_name(name)
            pool = free.get(base)
            if pool:
                inst = pool.pop(0)            # adopt: rename in place
                inst.spec = p.workload
                inst.r = p.r
                inst.batch = max(1, p.batch)
                inst.gpu = p.gpu
                inst.shed = False
                self._apply_shadow(inst, armed.get(name, 0.0))
            else:                             # scale-out: fresh replica
                sibling = next(i for i in instances
                               if replication.base_name(i.spec.name)
                               == base)
                instances.append(ServedInstance(
                    spec=p.workload, desc=sibling.desc, r=p.r,
                    batch=max(1, p.batch), gpu=p.gpu,
                    slo0=sibling.slo0,
                    shadow_r=armed.get(name, 0.0)))
        for pool in free.values():            # merged-away replicas
            for inst in pool:
                inst.r = self.hw.r_unit
                inst.batch = 1
                inst.shed = False             # zero share: no arrivals
                inst.spec = dataclasses.replace(inst.spec, rate_rps=0.0)
                self._apply_shadow(inst, 0.0)

    @staticmethod
    def _apply_shadow(inst: ServedInstance, sr: float) -> None:
        """Map the armed book onto one live instance.  Only ever writes
        on a CHANGE, and a released reservation deactivates too — with
        nothing armed this is a no-op on every instance, which is what
        keeps forecast-off runs byte-identical to the reactive build."""
        if sr != inst.shadow_r:
            inst.shadow_r = sr
            if sr <= 0.0:
                inst.shadow_active = False

    @property
    def hw(self) -> HardwareSpec:
        return self.reconciler.hw
