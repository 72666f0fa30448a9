"""Discrete-event GPU-cluster serving simulator (ground truth).

Three roles:

1. **ProfilingTestbed** (`SimTestbed`): what Nsight Systems/Compute +
   nvidia-smi provide on hardware — solo and co-located steady-state runs
   returning per-phase latencies, power, bandwidth utilization.  The
   iGniter coefficients are fit against these.

2. **Serving simulation** (`simulate_plan`): event-driven request/batch/
   serve loop per workload with constant-rate (or Poisson) arrivals,
   greedy dynamic batching up to the configured batch size, spatial
   co-location physics from `repro_torch.serving.physics`, per-request latency
   records (P99), the GSLICE-style reactive controller hook, and the
   iGniter shadow-instance failover (Sec. 4.2).  Two engines:

   * ``engine="vec"`` (default): devices are independent, and between
     monitor/adjust epochs a device's co-location state is static, so
     each instance's pass latency over effective batch nb in [1, b] is
     precomputed in ONE `physics.device_state_batch` call and the event
     loop runs per device as a pass recurrence over pre-generated
     arrival arrays — no global million-entry heap, no per-event
     physics call.  Noise is applied as sampled multipliers on the
     cached base values.  Tables are invalidated on shadow activation
     and after every `adjust_fn` call, so GSLICE/shadow scenarios stay
     exact.
   * ``engine="scalar"``: the original global-heap event loop, kept as
     the oracle — same seed => byte-identical per-request latency
     streams and SimResult metrics (`tests/test_sim_equivalence.py`).

   Both engines draw from per-instance RNG streams
   (``default_rng([seed, i, k])``: k=0 arrivals, k=1 active-time noise,
   k=2 dispatch noise) so no draw depends on cross-device event
   interleaving — that is what makes the per-device loop exact.

   The ``adjust_fn`` hook has a UNIFIED contract across engines (see
   `AdjustFn`): ``adjust_scope="device"`` (default) calls it once per
   device with that device's instances, ``adjust_scope="cluster"`` once
   per period with ALL instances — under either scope and either engine
   the callback sees the same synced state (pending ``queue``,
   ``recent_arrivals`` for the last adjust interval, ``busy_until``,
   ``completed``) and may mutate ``r`` / ``batch`` / ``shadow_r`` /
   ``gpu`` (migration).  Reconfigurations are tracked in
   ``SimResult.stats`` as ``n_reconfigs`` (instances whose placement
   changed at an adjust tick; engine-identical) and
   ``reconfig_latency_ms`` (wall-clock spent inside the callback — the
   controller-overhead number the paper reports in Sec. 5.5).

   Dynamic load: pass a ``repro_torch.serving.traces.Trace`` as ``trace`` to
   replace each workload's constant rate with a piecewise-constant
   schedule (diurnal ramps, flash-crowd spikes, churn).  Arrivals are
   pre-generated in `_setup` from the shared per-instance RNG streams,
   so traced scenarios stay byte-identical across engines too.

   Replica groups (docs/simulator.md): a workload served by replicas
   ``w#0..w#k-1`` draws ONE pooled arrival stream at the summed share
   rate, split rate-proportionally by `_split_stream` (deterministic
   weighted round-robin; Poisson thinning) so each slice is a faithful
   share of the workload's traffic and the pooled stream is exactly
   partitioned.  At adjust ticks `_resync_replicas` re-splits the
   FUTURE tail whenever the controller splits/merges a group or
   appends a fresh replica instance (cluster scope only) — past
   arrivals keep their assignment.  `SimResult.per_workload`,
   `request_latencies` and `violations` merge replicas back to BASE
   names (pooled percentiles, summed rates); `SimResult.per_replica`
   keeps the unmerged view.  A plan with no replicas takes the exact
   pre-replication code paths, byte for byte.

3. **Full-cluster validation** (`simulate_full`): every device of an
   m=1000-scale plan simulated at ground truth with events/sec
   throughput reported in `SimResult.stats` — tracked per PR by
   `benchmarks/scale_sweep.py` next to the model-predicted violations.

A copy of the JAX package's ``repro.serving.simulator``.  Its one
intended difference is the backend of the vec engine's bulk latency-table
builds: ``backend="torch"`` (the default) evaluates each chunk on
``device`` through `repro_torch.serving.physics_torch` (the CUDA kernel
``tables_kernel`` on a card, its plain float64 torch version on the CPU),
``backend="numpy"`` is the reference's numpy oracle, byte for byte.  The
event loop, the pass recurrence, rounding and percentiles stay on the
host in both.
"""
from __future__ import annotations

import heapq
import math
import time as _time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import replication
from repro_torch.core.coefficients import ProfileSample
from repro_torch.core.types import HardwareSpec, ProvisioningPlan, WorkloadSpec
from repro_torch.profiling.metrics import ServedModelDesc
from repro_torch.serving import faults as faults_mod
from repro_torch.device import resolve_device
from repro_torch.serving import physics
from repro_torch.serving import physics_torch
from repro_torch.serving import telemetry as telemetry_mod
from repro_torch.serving import traces as traces_mod

MONITOR_WINDOW_MS = 1000.0       # P99 monitor lookback (1 s, paper Sec. 4.2)


# ---------------------------------------------------------------------------
# Profiling testbed
# ---------------------------------------------------------------------------

class SimTestbed:
    """ProfilingTestbed over the ground-truth physics (deterministic:
    profiling averages away noise on real hardware too)."""

    def __init__(self, models: Dict[str, ServedModelDesc], hw: HardwareSpec,
                 noisy: bool = False, seed: int = 0):
        self.models = models
        self.hw = hw
        self.rng = np.random.default_rng(seed) if noisy else None

    def _sample(self, desc: ServedModelDesc, b: int, st: physics.TrueState
                ) -> ProfileSample:
        return ProfileSample(
            model=desc.name, batch=b, r=0.0,
            t_load=st.t_load, t_sched=st.t_sched, t_act=st.t_act,
            t_feedback=st.t_feedback, power=st.power,
            cache_util=st.cache_util, n_kernels=desc.n_kernels,
            d_load=desc.d_load_mb * b, d_feedback=desc.d_feedback_mb * b,
            device_freq=st.freq, device_power=st.device_power)

    def run_solo(self, model: str, batch: int, r: float) -> ProfileSample:
        desc = self.models[model]
        st = physics.device_state([(desc, batch, r)], self.hw, self.rng)[0]
        s = self._sample(desc, batch, st)
        return ProfileSample(**{**s.__dict__, "r": r})

    def run_colocated(self, entries: Sequence[Tuple[str, int, float]]
                      ) -> List[ProfileSample]:
        ds = [(self.models[m], b, r) for (m, b, r) in entries]
        sts = physics.device_state(ds, self.hw, self.rng)
        out = []
        for (m, b, r), st in zip(entries, sts):
            s = self._sample(self.models[m], b, st)
            out.append(ProfileSample(**{**s.__dict__, "r": r}))
        return out


# ---------------------------------------------------------------------------
# Discrete-event serving simulation
# ---------------------------------------------------------------------------

@dataclass
class ServedInstance:
    """One serving process (Triton-process analogue) on a device."""
    spec: WorkloadSpec
    desc: ServedModelDesc
    r: float
    batch: int
    gpu: int
    shadow_r: float = 0.0        # extra resources granted when shadow active
    shadow_active: bool = False
    queue: List[float] = field(default_factory=list)   # arrival times
    busy_until: float = 0.0
    latencies: List[float] = field(default_factory=list)
    waits: List[float] = field(default_factory=list)   # serve start - arrival
    completed: int = 0
    # overload admission (docs/control-plane.md): while ``shed`` the
    # front door rejects this instance's arrivals — queued backlog is
    # rejected at the shed tick, new arrivals are counted into
    # ``shed_count`` instead of being served.  Toggled ONLY at adjust
    # boundaries (the controller's tick), which is what keeps shed
    # accounting byte-identical across both engines.  ``slo0`` pins the
    # SLO the instance was CREATED with, so per-class violation
    # accounting stays honest under brownout (loosened plan SLOs).
    shed: bool = False
    shed_count: int = 0
    slo0: float = 0.0
    # arrivals in the last adjust interval, synced before adjust_fn calls
    # (identical across engines: both slice the pre-generated streams)
    recent_arrivals: np.ndarray = field(
        default_factory=lambda: np.empty(0))

    @property
    def r_eff(self) -> float:
        return self.r + (self.shadow_r if self.shadow_active else 0.0)


@dataclass
class SimResult:
    # keyed by BASE workload name: a replica group's requests are merged
    # back into one pooled per-workload record (docs/simulator.md);
    # per_replica keeps the unmerged per-instance view
    per_workload: Dict[str, Dict[str, float]]
    timeline: List[Dict] = field(default_factory=list)
    request_latencies: Dict[str, np.ndarray] = field(default_factory=dict)
    request_waits: Dict[str, np.ndarray] = field(default_factory=dict)
    per_replica: Dict[str, Dict[str, float]] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    def _latency_ms(self, name: str, metric) -> float:
        """One latency figure for `metric`: "p99", "avg", or a quantile
        in (0, 1) evaluated over the per-request latency stream."""
        if isinstance(metric, float):
            lats = self.request_latencies.get(name)
            if lats is None or lats.size == 0:
                return math.inf
            return float(np.percentile(lats, 100.0 * metric))
        return self.per_workload[name][f"{metric}_ms"]

    def violations(self, specs: Dict[str, WorkloadSpec], *,
                   metric="p99", check_rate: bool = True) -> List[str]:
        """Workloads violating their SLO at `metric` latency accounting
        ("p99" default, "avg" for mean-latency accounting, or a float
        quantile) and/or missing 95% of the target arrival rate."""
        out = []
        for name, m in self.per_workload.items():
            s = specs[name]
            if (self._latency_ms(name, metric) > s.slo_ms + 1e-9
                    or (check_rate and m["rps"] < 0.95 * s.rate_rps)):
                out.append(name)
        return out

    def violation_rates(self, specs: Dict[str, WorkloadSpec]
                        ) -> Dict[str, float]:
        """Per-workload fraction of individual requests over the SLO."""
        out = {}
        for name, lats in self.request_latencies.items():
            s = specs[name]
            out[name] = (float(np.mean(lats > s.slo_ms))
                         if lats.size else 1.0)
        return out


AdjustFn = Callable[[float, List[ServedInstance]], None]
# Called every `adjust_period` sim-seconds with (now, instances).  The
# grouping is engine-INDEPENDENT and set by ``adjust_scope``:
#   * "device" (default): once per device with that device's instances,
#     sorted by device id — an instance-local/GSLICE-style callback;
#   * "cluster": once per period with ALL instances — what a global
#     controller (the JAX package's repro.serving.controller) needs.
# Under both scopes the callback may mutate r / batch / shadow_r and
# (under any scope) gpu — migrations regroup devices and invalidate the
# vec engine's latency tables for touched devices only.  queue,
# latencies, busy_until, completed and recent_arrivals are synced
# read-only views; mutating them has no effect in the vec engine.


# ---------------------------------------------------------------------------
# Shared helpers (both engines): arrivals, noise, setup, read-out.  These
# being shared is what pins scalar and vec to identical RNG streams.
# ---------------------------------------------------------------------------

def _gen_arrivals(rate_rps: float, horizon_ms: float, poisson: bool,
                  rng: np.random.Generator) -> np.ndarray:
    """All arrival times in [0, horizon) for one instance, pre-generated
    with vectorized RNG.  The stream depends only on (seed, instance)."""
    period = 1000.0 / rate_rps
    t0 = float(rng.uniform(0, period))
    if t0 >= horizon_ms:
        return np.empty(0)
    if not poisson:
        n = int(math.ceil((horizon_ms - t0) / period))
        ts = t0 + period * np.arange(n + 1)
        return ts[ts < horizon_ms]
    chunks = [np.array([t0])]
    last = t0
    est = max(16, int((horizon_ms - t0) / period * 1.2))
    while last < horizon_ms:
        gaps = rng.exponential(period, size=est)
        ts = last + np.cumsum(gaps)
        chunks.append(ts)
        last = float(ts[-1])
        est = max(16, est // 4)
    arr = np.concatenate(chunks)
    return arr[arr < horizon_ms]


class _NoiseStream:
    """Chunk-buffered lognormal multipliers.  Both engines consume the
    same stream through the same chunking, so values match bitwise."""
    __slots__ = ("rng", "sigma", "buf", "k")
    CHUNK = 512

    def __init__(self, rng: np.random.Generator, sigma: float):
        self.rng = rng
        self.sigma = sigma
        self.buf: List[float] = []
        self.k = 0

    def next(self) -> float:
        if self.k >= len(self.buf):
            self.buf = self.rng.lognormal(0.0, self.sigma, self.CHUNK).tolist()
            self.k = 0
        v = self.buf[self.k]
        self.k += 1
        return v


def _noisy_t_inf(t_load: float, t_sch: float, t_act: float, t_fb: float,
                 slow: float, na: float, ns: float) -> float:
    """One serving pass latency from noise-free base values + sampled
    multipliers (na on active time, ns on dispatch)."""
    return t_load + (t_sch * ns + t_act * na) / slow + t_fb


# ---------------------------------------------------------------------------
# Replica groups: arrival-stream splitting (docs/simulator.md).  A base
# workload's requests form ONE pooled stream; replicas `w#0..w#k-1`
# each receive a rate-share slice of it.  Splitting is deterministic
# given (pooled stream, shares, split version) and lives in helpers
# shared by both engines — that is what keeps replicated and runtime-
# split runs byte-identical across the scalar oracle and the vec engine.
# ---------------------------------------------------------------------------

def _split_stream(arr: np.ndarray, fracs: Sequence[float], poisson: bool,
                  rng: np.random.Generator) -> List[np.ndarray]:
    """Partition pooled arrivals among k replicas by rate fraction.

    Deterministic arrivals: weighted round-robin — each replica j with
    fraction f_j owns virtual slots at (m+1)/f_j, and the merged sorted
    slot order (ties to the lower replica index) assigns arrivals
    rate-proportionally with maximal interleaving.  Poisson arrivals:
    i.i.d. thinning — one uniform draw per arrival picks the replica,
    so each slice is itself Poisson at its share rate.  Zero-share
    replicas receive nothing; an all-zero share vector leaves the whole
    stream on replica 0 (a parked group still drains its arrivals).
    """
    k = len(fracs)
    if k == 1:
        return [arr]
    n = arr.size
    if n == 0:
        return [np.empty(0) for _ in range(k)]
    fr = np.asarray(fracs, dtype=np.float64)
    total = float(fr.sum())
    if total <= 0.0:
        return [arr] + [np.empty(0) for _ in range(k - 1)]
    fr = fr / total
    if poisson:
        cum = np.cumsum(fr)
        cum[-1] = max(cum[-1], 1.0)
        u = rng.uniform(0.0, 1.0, size=n)
        assign = np.searchsorted(cum, u, side="right")
    else:
        slots = []
        ids = []
        for j, f in enumerate(fr):
            if f <= 0.0:
                continue
            nj = int(math.ceil(n * f)) + k + 1
            slots.append(np.arange(1.0, nj + 1.0) / f)
            ids.append(np.full(nj, j, dtype=np.int64))
        t = np.concatenate(slots)
        r = np.concatenate(ids)
        order = np.lexsort((r, t))[:n]
        assign = r[order]
    return [arr[assign == j] for j in range(k)]


def _replica_members(instances: List[ServedInstance]
                     ) -> Dict[str, List[int]]:
    """Instance indices grouped by base workload name, in replica order
    (replica index, then instance order — stable across engines)."""
    groups: Dict[str, List[int]] = {}
    for i, inst in enumerate(instances):
        groups.setdefault(replication.base_name(inst.spec.name),
                          []).append(i)
    for base, idxs in groups.items():
        idxs.sort(key=lambda i: (replication.replica_index(
            instances[i].spec.name) or 0, i))
    return groups


class _ReplicaRouter:
    """Book-keeping for pooled base streams and their current split.

    ``base``/``anchor`` hold, per base workload, the pooled arrival
    array and the instance index whose RNG stream generated it (replica
    0 at setup); ``sig`` caches the last applied membership signature —
    member indices plus NORMALIZED shares, so equal-proportion resizes
    never force a pointless re-split; ``version`` counts re-splits to
    key the thinning RNG (``default_rng([seed, anchor, 3, version])``).
    """
    __slots__ = ("seed", "poisson", "base", "anchor", "version", "sig")

    def __init__(self, seed: int, poisson: bool):
        self.seed = seed
        self.poisson = poisson
        self.base: Dict[str, np.ndarray] = {}
        self.anchor: Dict[str, int] = {}
        self.version: Dict[str, int] = {}
        self.sig: Dict[str, tuple] = {}

    @staticmethod
    def signature(members: Sequence[Tuple[int, float]]) -> tuple:
        total = sum(sh for _, sh in members)
        if total <= 0.0:
            total = 1.0
        return tuple((i, round(sh / total, 9)) for i, sh in members)

    def assign_rng(self, base: str) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, self.anchor[base], 3, self.version[base]])


def _resync_replicas(router: _ReplicaRouter,
                     instances: List[ServedInstance],
                     arrivals: List[np.ndarray],
                     now_ms: float) -> List[int]:
    """Re-split changed replica groups' FUTURE arrivals (> now) after an
    adjust tick: splits, merges, renames and appended instances all show
    up as a membership/share-signature change.  Arrivals at or before
    ``now`` keep their existing assignment (they were already queued or
    served).  Returns the instance indices whose arrays changed —
    shared by both engines, so the re-split is exact by construction.
    """
    changed: List[int] = []
    for base, idxs in sorted(_replica_members(instances).items()):
        members = [(i, instances[i].spec.rate_rps) for i in idxs]
        sig = router.signature(members)
        if sig == router.sig.get(base):
            continue
        router.sig[base] = sig
        if base not in router.base:
            continue       # no pooled stream (workload unknown at setup)
        barr = router.base[base]
        tail = barr[int(np.searchsorted(barr, now_ms, side="right")):]
        router.version[base] += 1
        parts = _split_stream(tail, [sh for _, sh in members],
                              router.poisson, router.assign_rng(base))
        for i, part in zip(idxs, parts):
            old = arrivals[i]
            past = old[:int(np.searchsorted(old, now_ms, side="right"))]
            arrivals[i] = np.concatenate([past, part]) \
                if past.size else part
            changed.append(i)
    return changed


def _setup(plan: ProvisioningPlan, models: Dict[str, ServedModelDesc],
           shadow: bool, shadow_extra: float, horizon_ms: float,
           poisson: bool, seed: int,
           trace: Optional["traces_mod.Trace"] = None):
    """Instances, device grouping, per-instance arrival arrays, noise
    streams and the replica router — identical for both engines.  With
    a `trace`, workloads it names (by BASE name) draw their arrivals
    from the piecewise-constant schedule instead of the static rate.

    Replica groups (`w#0..w#k-1`) get ONE pooled stream at the summed
    share rate, generated from replica 0's RNG stream and split by
    `_split_stream`; an unreplicated workload keeps the exact
    pre-replication path (same RNG key, same array), which is what
    makes k=1 plans byte-identical to pre-replication output.
    """
    instances: List[ServedInstance] = []
    for p in plan.placements:
        instances.append(ServedInstance(
            spec=p.workload, desc=models[p.workload.model], r=p.r,
            batch=max(1, p.batch), gpu=p.gpu, slo0=p.workload.slo_ms))
    by_gpu: Dict[int, List[int]] = {}
    for i, inst in enumerate(instances):
        by_gpu.setdefault(inst.gpu, []).append(i)

    if shadow:
        for inst in instances:
            used = sum(instances[k].r for k in by_gpu[inst.gpu])
            inst.shadow_r = min(shadow_extra, max(0.0, 1.0 - used))

    router = _ReplicaRouter(seed, poisson)
    arrivals: List[Optional[np.ndarray]] = [None] * len(instances)
    for base, idxs in _replica_members(instances).items():
        anchor = idxs[0]
        rate = float(sum(instances[i].spec.rate_rps for i in idxs))
        rng = np.random.default_rng([seed, anchor, 0])
        if trace is not None and base in trace.scales:
            edges, scales = trace.segments(base, horizon_ms)
            pooled = traces_mod.gen_arrivals(rate, edges, scales,
                                             horizon_ms, poisson, rng)
        else:
            pooled = _gen_arrivals(rate, horizon_ms, poisson, rng)
        router.base[base] = pooled
        router.anchor[base] = anchor
        router.version[base] = 0
        members = [(i, instances[i].spec.rate_rps) for i in idxs]
        router.sig[base] = router.signature(members)
        if len(idxs) == 1:
            arrivals[anchor] = pooled
        else:
            parts = _split_stream(pooled, [sh for _, sh in members],
                                  poisson, router.assign_rng(base))
            for i, part in zip(idxs, parts):
                arrivals[i] = part
    noise_a = [_NoiseStream(np.random.default_rng([seed, i, 1]),
                            physics.NOISE_SIGMA)
               for i in range(len(instances))]
    noise_s = [_NoiseStream(np.random.default_rng([seed, i, 2]),
                            2 * physics.NOISE_SIGMA)
               for i in range(len(instances))]
    return instances, by_gpu, arrivals, noise_a, noise_s, router


def _epoch_times(horizon_ms: float, monitor_period_s: float,
                 adjust_fn: Optional[AdjustFn], adjust_period_s: float
                 ) -> Tuple[List[float], List[float]]:
    mon = [float(t) for t in np.arange(monitor_period_s * 1000.0, horizon_ms,
                                       monitor_period_s * 1000.0)]
    adj = []
    if adjust_fn is not None:
        adj = [float(t) for t in np.arange(adjust_period_s * 1000.0,
                                           horizon_ms,
                                           adjust_period_s * 1000.0)]
    return mon, adj


def _stats(n_requests: int, n_passes: int, peak_window: int,
           wall0: float, n_reconfigs: int = 0,
           reconfig_ms: float = 0.0) -> Dict[str, float]:
    wall = _time.perf_counter() - wall0
    return {"n_requests": n_requests, "n_passes": n_passes,
            "n_events": n_requests + n_passes, "wall_s": wall,
            "events_per_s": (n_requests + n_passes) / max(wall, 1e-9),
            "peak_window": peak_window,
            # controller overhead accounting (paper Sec. 5.5 analogue):
            # n_reconfigs counts instances whose placement (gpu / r /
            # batch / shadow) changed at an adjust tick — engine-
            # identical; reconfig_latency_ms is adjust_fn wall-clock.
            "n_reconfigs": n_reconfigs,
            "reconfig_latency_ms": reconfig_ms}


def _snap_placement(inst: ServedInstance):
    return (inst.gpu, inst.r, inst.batch, inst.shadow_r,
            inst.shadow_active)


def _call_adjust(adjust_fn: AdjustFn, now_s: float,
                 insts: List[ServedInstance]
                 ) -> Tuple[List[Tuple[ServedInstance, int]],
                            List[ServedInstance], float]:
    """Invoke the callback; return ([(changed_inst, old_gpu)],
    [appended new instances], wall_ms).  A "reconfiguration" is any
    change to an instance's placement tuple (gpu, r, batch, shadow_r,
    shadow_active); a scale-out callback may APPEND fresh
    `ServedInstance`s (replica scale-out) to the list it was handed."""
    n0 = len(insts)
    snaps = [_snap_placement(i) for i in insts]
    t0 = _time.perf_counter()
    adjust_fn(now_s, insts)
    wall_ms = (_time.perf_counter() - t0) * 1000.0
    changed = [(inst, s[0]) for inst, s in zip(insts[:n0], snaps)
               if _snap_placement(inst) != s]
    return changed, list(insts[n0:]), wall_ms


def _dispatch_adjust(adjust_fn: AdjustFn, now_s: float,
                     instances: List[ServedInstance],
                     by_gpu: Dict[int, List[int]], adjust_scope: str
                     ) -> Tuple[List[Tuple[ServedInstance, int]],
                                List[ServedInstance], float]:
    """Scope-aware adjust_fn dispatch, shared by BOTH engines so the
    call grouping/ordering that the byte-identical contract depends on
    lives in exactly one place.  Returns (changed instances with their
    pre-call gpu, appended instances, total wall ms).  Instance
    creation is a cluster-scope capability: under the per-device scope
    the callback only sees throwaway sub-lists, so an append there is
    rejected loudly instead of being dropped."""
    if adjust_scope == "cluster":
        calls = [instances]
    else:
        calls = [[instances[k] for k in by_gpu[g]] for g in sorted(by_gpu)]
    changed_all: List[Tuple[ServedInstance, int]] = []
    new_all: List[ServedInstance] = []
    wall_ms = 0.0
    for insts_c in calls:
        changed, new, dt = _call_adjust(adjust_fn, now_s, insts_c)
        if new and adjust_scope != "cluster":
            raise RuntimeError(
                "adjust_fn appended instances under adjust_scope="
                "'device'; replica scale-out requires "
                "adjust_scope='cluster'")
        changed_all.extend(changed)
        new_all.extend(new)
        wall_ms += dt
    return changed_all, new_all, wall_ms


def _emit_reconfigs(telemetry, now_ms: float,
                    changed: List[Tuple[ServedInstance, int]],
                    new: List[ServedInstance], wall_ms: float) -> None:
    """One typed ``reconfig`` event per placement mutation the adjust
    tick actually applied — the same (changed, new) sets `n_reconfigs`
    counts, shared by both engines, so the event log reconciles
    EXACTLY against ``SimResult.stats["n_reconfigs"]`` (the overflow-
    immune ``reconfig_events`` counter survives ring eviction).
    ``wall_ms`` is the tick's adjust_fn wall (host-side; excluded from
    the engine-identity contract)."""
    t_s = now_ms / 1000.0
    for inst, old_g in changed:
        telemetry.record_event(telemetry_mod.ControlEvent(
            t_s=t_s, kind="reconfig", workload=inst.spec.name,
            cause="adjust", post=((inst.gpu, inst.batch, inst.r),),
            gpu_from=old_g, gpu_to=inst.gpu, wall_ms=wall_ms))
    for inst in new:
        telemetry.record_event(telemetry_mod.ControlEvent(
            t_s=t_s, kind="reconfig", workload=inst.spec.name,
            cause="scale_out", post=((inst.gpu, inst.batch, inst.r),),
            gpu_from=-1, gpu_to=inst.gpu, wall_ms=wall_ms))


def _sync_recent_arrivals(instances: List[ServedInstance],
                          arrivals: List[np.ndarray], now: float,
                          window_ms: float) -> None:
    """Expose each instance's arrivals in (now - window, now] — the raw
    material for the controller's rate/burstiness estimators."""
    lo = now - window_ms
    for i, inst in enumerate(instances):
        a = arrivals[i]
        j0 = int(np.searchsorted(a, lo, side="right"))
        j1 = int(np.searchsorted(a, now, side="right"))
        inst.recent_arrivals = a[j0:j1]


def _regroup(instances: List[ServedInstance]) -> Dict[int, List[int]]:
    by_gpu: Dict[int, List[int]] = {}
    for i, inst in enumerate(instances):
        by_gpu.setdefault(inst.gpu, []).append(i)
    return by_gpu


def _attach_canary(adjust_fn: Optional[AdjustFn], fstate) -> None:
    """Hand a health-probe canary to a controller-style callback.

    The canary answers "run one reference pass on idle device ``gpu``
    at ``now_ms`` — what is measured/predicted?": the device's active
    straggler multiplier (noise averages away exactly as in profiling),
    ``inf`` while the device is down, 1.0 when clean.  Computed from the
    fault schedule BOTH engines share, so probe-readmission decisions
    are deterministic and engine-identical.  Callbacks without an
    ``attach_canary`` method are untouched (hook is opt-in)."""
    if adjust_fn is None:
        return
    attach = getattr(adjust_fn, "attach_canary", None)
    if not callable(attach):
        return

    def canary(gpu: int, now_ms: float) -> float:
        if fstate is None:
            return 1.0
        fl = fstate.dev.get(gpu)
        if fl is None:
            return 1.0
        starts, ends, mult = fl
        if starts:
            kf = bisect_right(starts, now_ms) - 1
            if kf >= 0 and now_ms < ends[kf]:
                return math.inf
        return mult

    attach(canary)


def _merge_overload_stats(adjust_fn: Optional[AdjustFn],
                          stats: Dict[str, float]) -> None:
    """Fold a controller-style callback's admission-layer report
    (brownout depth, shed/preemption counts) into ``stats``.  Callbacks
    without ``overload_stats``, and controllers whose admission layer
    took ZERO actions, contribute nothing — the cap-slack run's stats
    stay byte-identical to the pre-overload build."""
    if adjust_fn is None:
        return
    rep = getattr(adjust_fn, "overload_stats", None)
    if not callable(rep):
        return
    extra = rep()
    if extra:
        stats.update(extra)


class _FaultState:
    """Runtime fault bookkeeping shared by BOTH engines (docstring
    semantics in `repro_torch.serving.faults`).

    The schedule is pure data, so every decision here depends only on
    (schedule, arrival arrays, instance->device assignment at the
    boundary) — never on served-request state.  That is what keeps
    fault runs byte-identical across engines: the scalar heap may serve
    a chained pass at exactly a boundary time before the fault event
    (done has lower priority), the vec engine defers it to the next
    epoch, and neither order can change any outcome below.

    * **Fail boundary**: replicas of a >=2-member group resident on the
      failed device have their rate share zeroed (the pre-fail share is
      saved) and `_resync_replicas` re-splits the pooled stream's
      future tail, so surviving replicas absorb the dead one's traffic.
      Solo workloads keep their stream and accumulate backlog.
    * **Restart boundary**: saved shares are restored (unless the
      controller re-owned the spec in between — its plan rates win) and
      the tail re-splits back.  Recovery accounting marks, per instance
      resident on the device at restart, how many of its arrivals
      predate the restart: the outage's recovery time is how long past
      the restart the last of those requests completes (0 when the
      controller migrated everyone away first).
    """

    def __init__(self, fs: "faults_mod.FaultSchedule"):
        self.fs = fs
        # gpu -> (fail starts, restart ends, straggler multiplier);
        # plain lists for bisect in the hot pass loops
        self.dev: Dict[int, Tuple[List[float], List[float], float]] = {}
        for g in set(fs.down) | set(fs.slow):
            iv = fs.down.get(g)
            starts = [float(x) for x in iv[:, 0]] if iv is not None else []
            ends = [float(x) for x in iv[:, 1]] if iv is not None else []
            self.dev[g] = (starts, ends, fs.multiplier(g))
        self.saved: Dict[int, float] = {}      # inst idx -> pre-fail share
        # (restart_ms, [(inst idx, #arrivals <= restart)]) per outage
        self.outages: List[Tuple[float, List[Tuple[int, int]]]] = []

    def on_fail(self, g: int, now: float, instances, by_gpu, router,
                arrivals) -> List[int]:
        """Zero the shares of replicas on g; returns re-split indices."""
        groups = _replica_members(instances)
        changed = False
        for i in by_gpu.get(g, []):
            inst = instances[i]
            base = replication.base_name(inst.spec.name)
            if len(groups.get(base, ())) < 2:
                continue
            if inst.spec.rate_rps > 0.0:
                self.saved[i] = inst.spec.rate_rps
                inst.spec = replace(inst.spec, rate_rps=0.0)
                changed = True
        return _resync_replicas(router, instances, arrivals, now) \
            if changed else []

    def on_restart(self, g: int, now: float, instances, by_gpu, router,
                   arrivals) -> List[int]:
        """Record recovery marks, restore saved shares; re-split."""
        members = by_gpu.get(g, [])
        self.outages.append((now, [
            (i, int(np.searchsorted(arrivals[i], now, side="right")))
            for i in members]))
        restored = False
        for i in members:
            saved = self.saved.pop(i, None)
            if saved is not None and instances[i].spec.rate_rps == 0.0:
                instances[i].spec = replace(instances[i].spec,
                                            rate_rps=saved)
                restored = True
        return _resync_replicas(router, instances, arrivals, now) \
            if restored else []

    def fault_stats(self, dones: List[List[float]], horizon_ms: float,
                    n_requests: int, n_served: int) -> Dict[str, float]:
        """Downtime / lost-request / recovery accounting for
        `SimResult.stats` — computed from arrival counts and completion
        stamps both engines agree on bitwise."""
        rec = []
        for (r, marks) in self.outages:
            worst = 0.0
            for (i, n) in marks:
                if n <= 0:
                    continue           # nothing pending at the restart
                dn = dones[i]
                late = dn[n - 1] - r if n <= len(dn) else horizon_ms - r
                if late > worst:
                    worst = late
            rec.append(max(0.0, worst))
        return {
            "n_failures": self.fs.n_failures(horizon_ms),
            "downtime_ms": self.fs.downtime_ms(horizon_ms),
            "lost_requests": n_requests - n_served,
            "n_recoveries": len(rec),
            "recovery_mean_ms": float(np.mean(rec)) if rec else 0.0,
        }


def _finalize(instances: List[ServedInstance], duration_s: float,
              timeline: List[Dict], stats: Dict[str, float]) -> SimResult:
    per = {}
    req = {}
    wts = {}
    per_rep = {}
    groups = _replica_members(instances)
    for base, idxs in groups.items():
        members = [instances[i] for i in idxs]
        # replica-merged per-workload accounting: one pooled request
        # stream per BASE workload (singleton groups reproduce the
        # pre-replication records bit-for-bit)
        lat_parts = [np.asarray(m.latencies) for m in members]
        wait_parts = [np.asarray(m.waits) for m in members]
        pooled_lat = np.concatenate(lat_parts) if len(members) > 1 \
            else lat_parts[0]
        pooled_wait = np.concatenate(wait_parts) if len(members) > 1 \
            else wait_parts[0]
        lats = pooled_lat if pooled_lat.size else np.array([np.inf])
        waits = pooled_wait if pooled_wait.size else np.array([np.inf])
        per[base] = {
            "p99_ms": float(np.percentile(lats, 99)),
            "p50_ms": float(np.percentile(lats, 50)),
            "avg_ms": float(np.mean(lats)),
            "wait_avg_ms": float(np.mean(waits)),
            "wait_p99_ms": float(np.percentile(waits, 99)),
            "rps": sum(m.completed for m in members) / duration_s,
            "r_final": sum(m.r_eff for m in members),
            "batch_final": members[0].batch,
            "shadow_used": any(m.shadow_active for m in members),
            "n_replicas": len(members),
        }
        req[base] = pooled_lat
        wts[base] = pooled_wait
        if len(members) > 1 or replication.is_replica(
                members[0].spec.name):
            for m in members:
                m_lats = np.asarray(m.latencies)
                per_rep[m.spec.name] = {
                    "p99_ms": float(np.percentile(m_lats, 99))
                    if m_lats.size else math.inf,
                    "rps": m.completed / duration_s,
                    "rate_share_rps": m.spec.rate_rps,
                    "r_final": m.r_eff,
                    "batch_final": m.batch,
                    "gpu": m.gpu,
                }
    # cluster-wide end-to-end latency + queueing-delay aggregates: the
    # measured counterpart of the provisioner's t_queue budget term
    all_lats = np.concatenate([v for v in req.values() if v.size]) \
        if any(v.size for v in req.values()) else np.array([np.inf])
    all_waits = np.concatenate([v for v in wts.values() if v.size]) \
        if any(v.size for v in wts.values()) else np.array([np.inf])
    stats = dict(stats)
    stats.update({
        "e2e_p50_ms": float(np.percentile(all_lats, 50)),
        "e2e_p99_ms": float(np.percentile(all_lats, 99)),
        "wait_mean_ms": float(np.mean(all_waits)),
        "wait_p99_ms": float(np.percentile(all_waits, 99)),
    })
    # Overload accounting — GATED: every key below is absent unless a
    # request was actually shed or the controller reported admission
    # activity, which is what keeps cap-slack runs byte-identical to
    # pre-overload output.  Violation rates are measured against each
    # instance's CREATION-time SLO (``slo0``), so a brownout (loosened
    # working SLO) can never hide a violation from the per-class stats.
    total_shed = sum(inst.shed_count for inst in instances)
    if total_shed > 0 or stats.get("overload_active"):
        stats["shed_requests"] = float(total_shed)
        by_class: Dict[int, List[str]] = {}
        for base, idxs in groups.items():
            members = [instances[i] for i in idxs]
            per[base]["shed_requests"] = float(
                sum(m.shed_count for m in members))
            by_class.setdefault(int(members[0].spec.priority),
                                []).append(base)
        for pr, bases in sorted(by_class.items()):
            viol = served = shed = 0
            for b in bases:
                idxs = groups[b]
                slo0 = instances[idxs[0]].slo0
                viol += int(np.sum(req[b] > slo0))
                served += int(req[b].size)
                shed += sum(instances[i].shed_count for i in idxs)
            stats[f"class{pr}_workloads"] = float(len(bases))
            stats[f"class{pr}_violation_rate"] = \
                viol / served if served else 0.0
            stats[f"class{pr}_shed_rate"] = \
                shed / (served + shed) if (served + shed) else 0.0
    return SimResult(per_workload=per, timeline=timeline,
                     request_latencies=req, request_waits=wts,
                     per_replica=per_rep, stats=stats)


# ---------------------------------------------------------------------------
# Scalar oracle engine: one global event heap, one physics call per pass.
# ---------------------------------------------------------------------------

def _simulate_scalar(plan, models, hw, *, duration_s, seed, poisson, shadow,
                     shadow_extra, monitor_period_s, adjust_fn,
                     adjust_period_s, record_timeline, adjust_scope,
                     trace, faults, telemetry=None) -> SimResult:
    wall0 = _time.perf_counter()
    horizon = duration_s * 1000.0                      # ms
    instances, by_gpu, arrivals, noise_a, noise_s, router = _setup(
        plan, models, shadow, shadow_extra, horizon, poisson, seed, trace)
    fstate = _FaultState(faults) \
        if faults is not None and (faults.down or faults.slow) else None
    _attach_canary(adjust_fn, fstate)
    shed_prev = [False] * len(instances)

    # (t, prio, seq, kind, idx, ver): the kind priority pins the same-
    # time ordering the setup-time push order used to imply (arrival <
    # monitor < adjust < done < fault), so arrivals re-pushed MID-RUN by
    # a replica re-split keep the arrival-before-boundary contract the
    # vec engine's run_passes assumes
    events: List[Tuple[float, int, int, str, int, int]] = []
    seq = 0
    _PRIO = {"arrival": 0, "monitor": 1, "adjust": 2, "done": 3,
             "fault": 4}

    def push(t, kind, idx, ver=0):
        nonlocal seq
        heapq.heappush(events, (t, _PRIO[kind], seq, kind, idx, ver))
        seq += 1

    for i, arr in enumerate(arrivals):
        for t in arr.tolist():
            push(t, "arrival", i)
    # per-instance arrival-stream version: a replica re-split bumps it
    # and re-pushes the new tail, orphaning the stale queued events
    arr_ver = [0] * len(instances)
    mon, adj = _epoch_times(horizon, monitor_period_s, adjust_fn,
                            adjust_period_s)
    for t in mon:
        push(t, "monitor", -1)
    for t in adj:
        push(t, "adjust", -1)
    # fault boundaries: idx carries the DEVICE id, ver 0=fail 1=restart.
    # Restart events past the horizon still fire (the heap drains all
    # arrivals), mirroring the vec engine's final infinite epoch.
    if fstate is not None:
        for (tb, g, up) in fstate.fs.boundaries():
            push(tb, "fault", g, 1 if up else 0)
    # per-instance completion stamps, recovery accounting only (the vec
    # engine keeps these always as its monitor-window index)
    fault_dones: Optional[List[List[float]]] = \
        [[] for _ in instances] if fstate is not None else None

    timeline: List[Dict] = []
    # last-window latencies, pruned each monitor tick (bounded deque, NOT
    # an ever-growing list): (done_time, latency, wait) per request
    recent: List[deque] = [deque() for _ in instances]
    n_passes = 0
    peak_window = 0
    n_reconfigs = 0
    adjust_wall_ms = 0.0
    adj_window_ms = adjust_period_s * 1000.0

    def pass_latency(inst: ServedInstance, nb: int) -> physics.TrueState:
        peers = [instances[k] for k in by_gpu[inst.gpu]
                 if instances[k] is not inst]
        entries = [(inst.desc, nb, inst.r_eff)] + \
            [(p.desc, p.batch, p.r_eff) for p in peers]
        return physics.device_state(entries, hw)[0]

    def try_serve(i: int, now: float):
        nonlocal n_passes
        inst = instances[i]
        if not inst.queue or inst.busy_until > now:
            return
        fmult = 1.0
        if fstate is not None:
            fl = fstate.dev.get(inst.gpu)
            if fl is not None:
                fstarts, fends, fmult = fl
                if fstarts:
                    kf = bisect_right(fstarts, now) - 1
                    if kf >= 0 and now < fends[kf]:
                        return     # device down: backlog waits for the
                                   # restart wake (or is lost forever)
        nb = min(inst.batch, len(inst.queue))
        taken, inst.queue = inst.queue[:nb], inst.queue[nb:]
        st = pass_latency(inst, nb)
        slow = st.freq / hw.max_freq
        na = noise_a[i].next()
        ns = noise_s[i].next()
        t_inf = _noisy_t_inf(st.t_load, st.t_sched, st.t_act, st.t_feedback,
                             slow, na, ns)
        if fmult != 1.0:
            t_inf *= fmult         # straggler: the model never knows
        done = now + t_inf
        inst.busy_until = done
        for arr in taken:
            lat = done - arr
            inst.latencies.append(lat)
            inst.waits.append(now - arr)
            recent[i].append((done, lat, now - arr))
        if fault_dones is not None:
            fault_dones[i].extend([done] * nb)
        inst.completed += nb
        n_passes += 1
        push(done, "done", i)

    while events:
        now, _, _, kind, idx, ver = heapq.heappop(events)
        if kind == "arrival":
            if ver != arr_ver[idx]:
                continue               # stale stream (re-split tail)
            if instances[idx].shed:
                # admission layer rejects at the front door: counted,
                # never queued, never served (docs/control-plane.md)
                instances[idx].shed_count += 1
                continue
            instances[idx].queue.append(now)
            try_serve(idx, now)
        elif kind == "done":
            try_serve(idx, now)
        elif kind == "monitor":
            cutoff = now - MONITOR_WINDOW_MS
            tl_rows = [] if telemetry is not None else None
            for i, inst in enumerate(instances):
                dq = recent[i]
                while dq and dq[0][0] <= cutoff:
                    dq.popleft()
                # the monitor sees COMPLETED requests only: a pass still
                # in flight has its (done, lat) records stamped in the
                # future, and with passes longer than the lookback the
                # window is legitimately empty between completions
                window = [l for (d, l, _) in dq if d <= now]
                peak_window = max(peak_window, len(window))
                if tl_rows is not None:
                    # done stamps are nondecreasing per instance, so the
                    # window is exactly the first len(window) entries
                    k = len(window)
                    stamps_w: List[float] = []
                    waits_w: List[float] = []
                    for (d, _, wt) in dq:
                        if len(stamps_w) >= k:
                            break
                        stamps_w.append(d)
                        waits_w.append(wt)
                    tl_rows.append((i, window, waits_w, stamps_w,
                                    len(inst.queue)))
                if record_timeline:
                    timeline.append({
                        "t_s": now / 1000.0, "workload": inst.spec.name,
                        "p99_1s": float(np.percentile(window, 99)) if window else 0.0,
                        "avg_1s": float(np.mean(window)) if window else 0.0,
                        "r": inst.r_eff, "batch": inst.batch,
                        "rps_1s": len(window) / 1.0,
                        "shadow": inst.shadow_active,
                    })
                # Sec. 4.2 activation: simulator-armed (shadow=True) OR
                # controller-armed (inst.shadow_r set by the predictive
                # tier) — per-instance, so a run with nothing armed
                # evaluates exactly as before
                if ((shadow or inst.shadow_r > 0.0) and window
                        and not inst.shadow_active):
                    if float(np.percentile(window, 99)) > inst.spec.slo_ms:
                        # switch to the pre-launched shadow process (Sec. 4.2)
                        inst.shadow_active = True
            if tl_rows is not None:
                telemetry.sample_tick(now, instances, by_gpu, hw, tl_rows)
        elif kind == "adjust" and adjust_fn is not None:
            _sync_recent_arrivals(instances, arrivals, now, adj_window_ms)
            n_before = len(instances)
            changed, new, wall_ms = _dispatch_adjust(
                adjust_fn, now / 1000.0, instances, by_gpu, adjust_scope)
            n_reconfigs += len(changed) + len(new)
            adjust_wall_ms += wall_ms
            if telemetry is not None:
                _emit_reconfigs(telemetry, now, changed, new, wall_ms)
                telemetry.add_wall("sim_adjust", wall_ms)
            for j in range(n_before, len(instances)):
                # appended replica: fresh per-instance RNG streams keyed
                # by its (new, never-reused) global index — the vec
                # engine derives the identical keys
                noise_a.append(_NoiseStream(
                    np.random.default_rng([seed, j, 1]),
                    physics.NOISE_SIGMA))
                noise_s.append(_NoiseStream(
                    np.random.default_rng([seed, j, 2]),
                    2 * physics.NOISE_SIGMA))
                arrivals.append(np.empty(0))
                recent.append(deque())
                arr_ver.append(0)
                shed_prev.append(False)
                if fault_dones is not None:
                    fault_dones.append([])
            for i, inst in enumerate(instances):
                if inst.shed and not shed_prev[i]:
                    # shedding starts at this tick: the queued backlog
                    # is rejected too (not yet admitted to a pass); the
                    # in-flight pass, if any, completes
                    inst.shed_count += len(inst.queue)
                    inst.queue.clear()
                shed_prev[i] = inst.shed
            for i in _resync_replicas(router, instances, arrivals, now):
                arr_ver[i] += 1
                a = arrivals[i]
                for t in a[np.searchsorted(a, now, side="right"):].tolist():
                    push(t, "arrival", i, arr_ver[i])
            if new or any(old_g != inst.gpu for inst, old_g in changed):
                by_gpu = _regroup(instances)
            if fstate is not None and changed:
                # migration of a fault-blocked backlog: without faults,
                # a non-empty queue implies busy_until >= now, so this
                # clamp is a no-op in clean runs.  With it, the backlog
                # serves on the NEW device at the tick (the wake event),
                # exactly when the vec recurrence resumes it — never at
                # a pre-migration arrival stamp.
                pos = {id(inst): k for k, inst in enumerate(instances)}
                for inst, old_g in changed:
                    if old_g != inst.gpu and inst.busy_until < now:
                        inst.busy_until = now
                        push(now, "done", pos[id(inst)])
        elif kind == "fault":
            g = idx
            if ver == 1:
                resynced = fstate.on_restart(g, now, instances, by_gpu,
                                             router, arrivals)
            else:
                resynced = fstate.on_fail(g, now, instances, by_gpu,
                                          router, arrivals)
            for i in resynced:
                arr_ver[i] += 1
                a = arrivals[i]
                for t in a[np.searchsorted(a, now, side="right"):].tolist():
                    push(t, "arrival", i, arr_ver[i])
            if ver == 1:
                for i in by_gpu.get(g, []):
                    try_serve(i, now)      # restart wake: drain backlog

    if telemetry is not None:
        # per-pass scalar physics calls: the oracle's "dispatch" unit
        # (engine-specific by design, like the vec table-build counts)
        telemetry.count("dispatch_scalar", n_passes)
    stats = _stats(sum(len(a) for a in arrivals), n_passes, peak_window,
                   wall0, n_reconfigs, adjust_wall_ms)
    if fstate is not None:
        stats.update(fstate.fault_stats(
            fault_dones, horizon, sum(len(a) for a in arrivals),
            sum(inst.completed for inst in instances)))
    _merge_overload_stats(adjust_fn, stats)
    return _finalize(instances, duration_s, timeline, stats)


# ---------------------------------------------------------------------------
# Vectorized engine: per-device pass recurrence over cached latency tables.
# ---------------------------------------------------------------------------

class _LatTable:
    """Per-instance pass-latency base values over effective batch
    nb in [1, b], from ONE `device_state_batch` call.  Valid while the
    device's co-location state (peer batch/r_eff, own r_eff/batch cap)
    is unchanged — i.e. between shadow activations / adjust_fn calls."""
    __slots__ = ("t_load", "t_sch", "t_act", "t_fb", "slow")

    def __init__(self, inst: ServedInstance, peers: List[ServedInstance],
                 hw: HardwareSpec):
        descs = [inst.desc] + [p.desc for p in peers]
        bmax = max(1, inst.batch)
        n = len(descs)
        b = np.empty((bmax, n))
        r = np.empty((bmax, n))
        b[:, 0] = np.arange(1, bmax + 1)
        r[:, 0] = inst.r_eff
        for j, p in enumerate(peers):
            b[:, j + 1] = p.batch
            r[:, j + 1] = p.r_eff
        st = physics.device_state_batch(descs, b, r, hw)
        self.t_load = st.t_load[:, 0].tolist()
        self.t_sch = st.t_sched[:, 0].tolist()
        self.t_act = st.t_act[:, 0].tolist()
        self.t_fb = st.t_feedback[:, 0].tolist()
        self.slow = (st.freq / hw.max_freq).tolist()

    @classmethod
    def from_values(cls, t_load, t_sch, t_act, t_fb, slow) -> "_LatTable":
        """Table from precomputed columns (`_build_tables_bulk`)."""
        self = cls.__new__(cls)
        self.t_load, self.t_sch, self.t_act, self.t_fb, self.slow = (
            t_load, t_sch, t_act, t_fb, slow)
        return self


_BULK_CHUNK = 1 << 19    # max rows*n per bulk physics call (~50 MB live)


def _build_tables_bulk(instances: List[ServedInstance],
                       groups: Dict[int, List[int]], hw: HardwareSpec,
                       backend: str = "numpy",
                       device=None) -> Dict[int, "_LatTable"]:
    """Latency tables for every instance of ``groups`` in a handful of
    `physics.device_state_arrays` calls instead of one per instance.

    Jobs are bucketed by co-location width n (self + peers): within a
    bucket every row reduces over a last axis of exactly n entries —
    the same grouping the per-device `_LatTable` build sees — so the
    numpy backend is bitwise-identical to it, device by device.  Chunks
    bound transient memory at ~`_BULK_CHUNK` elements per array; rows
    are independent, so chunking cannot change results.  With
    ``backend="torch"`` each chunk is evaluated on ``device`` by
    `physics_torch.table_values` (<= 1e-6 relative vs numpy): one copy
    to the device, one kernel launch and one copy back per chunk.
    """
    tables: Dict[int, _LatTable] = {}
    buckets: Dict[int, List[Tuple[int, List[int]]]] = {}
    for g, idxs in groups.items():
        for i in idxs:
            cols = [i] + [k for k in idxs if k != i]
            buckets.setdefault(len(cols), []).append((i, cols))
    for n, jobs in sorted(buckets.items()):
        start = 0
        while start < len(jobs):
            end, rows = start, 0
            while end < len(jobs):
                bmax = max(1, instances[jobs[end][0]].batch)
                if rows and (rows + bmax) * n > _BULK_CHUNK:
                    break
                rows += bmax
                end += 1
            _build_tables_chunk(instances, jobs[start:end], n, rows, hw,
                                backend, tables, device)
            start = end
    return tables


def _build_tables_chunk(instances: List[ServedInstance],
                        jobs: List[Tuple[int, List[int]]], n: int,
                        rows: int, hw: HardwareSpec, backend: str,
                        tables: Dict[int, "_LatTable"],
                        device=None) -> None:
    arrays, blocks = _stage_chunk(instances, jobs, n, rows)
    if backend == "torch":
        vals = physics_torch.table_values(*arrays, n, hw, device=device)
    else:
        st = physics.device_state_arrays(*arrays, n, hw)
        vals = (st.t_load, st.t_sched, st.t_act, st.t_feedback, st.freq)
    _unpack_chunk(vals, blocks, hw, tables)


def _stage_chunk(instances: List[ServedInstance],
                 jobs: List[Tuple[int, List[int]]], n: int, rows: int):
    """The chunk's ``(rows, n)`` inputs of `physics.device_state_arrays`
    (d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r) and each
    job's (instance, first row, rows) block."""
    b = np.empty((rows, n))
    r = np.empty((rows, n))
    consts = [np.empty((rows, n)) for _ in range(6)]
    d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern = consts
    blocks: List[Tuple[int, int, int]] = []
    row = 0
    for (i, cols) in jobs:
        inst = instances[i]
        bmax = max(1, inst.batch)
        sl = slice(row, row + bmax)
        b[sl, 0] = np.arange(1, bmax + 1)
        r[sl, 0] = inst.r_eff
        for j, k in enumerate(cols[1:]):
            b[sl, j + 1] = instances[k].batch
            r[sl, j + 1] = instances[k].r_eff
        for j, k in enumerate(cols):
            dsc = instances[k].desc
            d_load[sl, j] = dsc.d_load_mb
            d_fb[sl, j] = dsc.d_feedback_mb
            flops_i[sl, j] = dsc.flops_per_item
            w_bytes[sl, j] = dsc.weight_bytes
            a_bytes[sl, j] = dsc.act_bytes_per_item
            n_kern[sl, j] = float(dsc.n_kernels)
        blocks.append((i, row, bmax))
        row += bmax
    return (*consts, b, r), blocks


def _unpack_chunk(vals, blocks: List[Tuple[int, int, int]], hw: HardwareSpec,
                  tables: Dict[int, "_LatTable"]) -> None:
    """Each job's `_LatTable` from the chunk's (t_load, t_sched, t_act,
    t_feedback, freq) values."""
    t_load, t_sch, t_act, t_fb, freq = vals
    slow = freq / hw.max_freq
    for (i, row0, bmax) in blocks:
        sl = slice(row0, row0 + bmax)
        tables[i] = _LatTable.from_values(
            t_load[sl, 0].tolist(), t_sch[sl, 0].tolist(),
            t_act[sl, 0].tolist(), t_fb[sl, 0].tolist(),
            slow[sl].tolist())


def _simulate_vec(plan, models, hw, *, duration_s, seed, poisson, shadow,
                  shadow_extra, monitor_period_s, adjust_fn,
                  adjust_period_s, record_timeline, adjust_scope,
                  trace, faults, telemetry=None,
                  backend="numpy", device=None) -> SimResult:
    wall0 = _time.perf_counter()
    horizon = duration_s * 1000.0
    instances, by_gpu, arrivals, noise_a, noise_s, router = _setup(
        plan, models, shadow, shadow_extra, horizon, poisson, seed, trace)
    n_inst = len(instances)
    fstate = _FaultState(faults) \
        if faults is not None and (faults.down or faults.slow) else None
    _attach_canary(adjust_fn, fstate)
    shed_prev = [False] * n_inst

    mon, adj = _epoch_times(horizon, monitor_period_s, adjust_fn,
                            adjust_period_s)
    mon_set, adj_set = set(mon), set(adj)
    # fault boundaries become epochs of their own: run_passes advances
    # everyone to the boundary, then the share zero/restore + re-split
    # runs — the same (t, gpu, is_up) order the scalar heap processes
    # its prio-4 fault events in
    fault_at: Dict[float, List[Tuple[int, bool]]] = {}
    if fstate is not None:
        for (tb, g, up) in fstate.fs.boundaries():
            fault_at.setdefault(tb, []).append((g, up))
    epochs = [(t, t in mon_set, t in adj_set)
              for t in sorted(mon_set | adj_set | set(fault_at))]
    epochs.append((math.inf, False, False))            # final drain

    arr_np = arrivals
    arr_l = [a.tolist() for a in arrivals]
    jptr = [0] * n_inst            # next unserved arrival index
    busy = [0.0] * n_inst
    completed = [0] * n_inst
    done_flat: List[List[float]] = [[] for _ in range(n_inst)]
    wptr = [0] * n_inst            # monitor-window start in done_flat
    n_passes = 0
    peak_window = 0
    n_reconfigs = 0
    adjust_wall_ms = 0.0
    adj_window_ms = adjust_period_s * 1000.0
    rows: List[Tuple[float, int, Dict]] = []           # timeline, sortable

    # Per-instance latency tables, built per device and invalidated only
    # for devices whose co-location state changed (shadow activation,
    # adjust_fn mutation, migration).  The loop is EPOCH-major (all
    # instances advance to each boundary before monitor/adjust fire) so
    # a cluster-scoped adjust_fn sees a consistent cluster snapshot;
    # per-instance RNG streams make this reordering exact vs the
    # device-major formulation.
    tables: Dict[int, _LatTable] = {}
    dispatch_key = "dispatch_torch" if backend == "torch" else "dispatch_numpy"

    def rebuild_gpu(g: int) -> None:
        tables.update(_build_tables_bulk(instances, {g: by_gpu[g]}, hw,
                                         backend=backend, device=device))
        if telemetry is not None:
            telemetry.count(dispatch_key)

    tables.update(_build_tables_bulk(instances, by_gpu, hw,
                                     backend=backend, device=device))
    if telemetry is not None:
        # table-build dispatches: the vec engine's physics-call unit
        # (engine/backend-specific by design; the identity contract
        # covers events + timelines, not dispatch counters)
        telemetry.count(dispatch_key)

    def run_passes(i: int, T: float) -> None:
        """Advance instance i's pass recurrence up to epoch boundary T.

        Replicates the oracle's event ordering: an arrival exactly at T
        is processed before the boundary (arrival events sort before
        monitor/adjust), a chained serve exactly at T after it.
        """
        nonlocal n_passes
        arr = arr_l[i]
        n_arr = len(arr)
        jj = jptr[i]
        if jj >= n_arr:
            return
        inst_i = instances[i]
        if inst_i.shed:
            # front-door rejection (mirrors the oracle's per-event drop;
            # arrivals exactly at T sort before the boundary there)
            j1 = bisect_right(arr, T, jj)
            if j1 > jj:
                inst_i.shed_count += j1 - jj
                jptr[i] = j1
                completed[i] = j1 - inst_i.shed_count
            return
        bu = busy[i]
        bcap = instances[i].batch
        tab = tables[i]
        t_load_t, t_sch_t, t_act_t, t_fb_t, slow_t = (
            tab.t_load, tab.t_sch, tab.t_act, tab.t_fb, tab.slow)
        na_s, ns_s = noise_a[i], noise_s[i]
        lats = instances[i].latencies
        wts = instances[i].waits
        dones = done_flat[i]
        anp = arr_np[i]
        # device fault view, fixed for this segment: the instance's gpu
        # only changes at adjust boundaries, which end every segment
        fstarts = fends = None
        fmult = 1.0
        if fstate is not None:
            fl = fstate.dev.get(instances[i].gpu)
            if fl is not None:
                fstarts, fends, fmult = fl
                if not fstarts:
                    fstarts = None
        while jj < n_arr:
            a = arr[jj]
            if bu > a:                 # chained serve at pass completion
                start = bu
                chained = True
            else:                      # idle: next arrival triggers
                start = a
                chained = False
            if fstarts is not None:
                kf = bisect_right(fstarts, start) - 1
                if kf >= 0 and start < fends[kf]:
                    # device down at the would-be pass start: the pass
                    # begins at the restart (inf for a permanent
                    # failure), the same instant the scalar engine's
                    # restart wake drains the backlog
                    start = fends[kf]
                    chained = True
            if chained:
                if start >= T:
                    break
            else:
                if start > T:
                    break
            nb = bisect_right(arr, start, jj) - jj
            if nb > bcap:
                nb = bcap
            k = nb - 1
            na = na_s.next()
            ns = ns_s.next()
            t_inf = _noisy_t_inf(t_load_t[k], t_sch_t[k], t_act_t[k],
                                 t_fb_t[k], slow_t[k], na, ns)
            if fmult != 1.0:
                t_inf *= fmult         # straggler: the model never knows
            done = start + t_inf
            lats.extend((done - anp[jj:jj + nb]).tolist())
            wts.extend((start - anp[jj:jj + nb]).tolist())
            dones.extend([done] * nb)
            jj += nb
            bu = done
            n_passes += 1
        jptr[i] = jj
        busy[i] = bu
        completed[i] = jj - inst_i.shed_count   # all served so far

    for (T, is_mon, is_adj) in epochs:
        for i in range(n_inst):
            run_passes(i, T)
        dirty: set = set()             # device ids needing table rebuilds
        if is_mon:
            cutoff = T - MONITOR_WINDOW_MS
            tl_rows = [] if telemetry is not None else None
            for i in range(n_inst):
                inst = instances[i]
                dn = done_flat[i]
                w = wptr[i]
                while w < len(dn) and dn[w] <= cutoff:
                    w += 1
                wptr[i] = w
                # completed-by-T only (mirrors the scalar monitor):
                # done stamps are nondecreasing per instance, and a
                # pass may complete past T (or past the horizon)
                end = bisect_right(dn, T, w)
                peak_window = max(peak_window, end - w)
                if (tl_rows is None and not record_timeline
                        and not shadow and inst.shadow_r <= 0.0):
                    continue           # window list only needed below
                window = inst.latencies[w:end]
                if tl_rows is not None:
                    # queue depth at T: arrivals admitted but not yet
                    # consumed by a pass — identical to the oracle's
                    # len(inst.queue) at the tick
                    tl_rows.append((i, window, inst.waits[w:end],
                                    dn[w:end],
                                    bisect_right(arr_l[i], T, jptr[i])
                                    - jptr[i]))
                if record_timeline:
                    rows.append((T, i, {
                        "t_s": T / 1000.0, "workload": inst.spec.name,
                        "p99_1s": float(np.percentile(window, 99)) if window else 0.0,
                        "avg_1s": float(np.mean(window)) if window else 0.0,
                        "r": inst.r_eff, "batch": inst.batch,
                        "rps_1s": len(window) / 1.0,
                        "shadow": inst.shadow_active,
                    }))
                # activation for simulator- OR controller-armed shadows
                # (mirrors the scalar monitor, incl. the table rebuild)
                if ((shadow or inst.shadow_r > 0.0) and window
                        and not inst.shadow_active):
                    if float(np.percentile(window, 99)) > inst.spec.slo_ms:
                        inst.shadow_active = True
                        dirty.add(inst.gpu)
            if tl_rows is not None:
                telemetry.sample_tick(T, instances, by_gpu, hw, tl_rows)
        if is_adj and adjust_fn is not None:
            for i in range(n_inst):
                inst = instances[i]
                inst.busy_until = busy[i]
                inst.completed = completed[i]
                al = arr_l[i]
                inst.queue = al[jptr[i]:bisect_right(al, T, jptr[i])]
            _sync_recent_arrivals(instances, arr_np, T, adj_window_ms)
            n_before = n_inst
            changed, new, wall_ms = _dispatch_adjust(
                adjust_fn, T / 1000.0, instances, by_gpu, adjust_scope)
            n_reconfigs += len(changed) + len(new)
            adjust_wall_ms += wall_ms
            if telemetry is not None:
                _emit_reconfigs(telemetry, T, changed, new, wall_ms)
                telemetry.add_wall("sim_adjust", wall_ms)
            for j in range(n_before, len(instances)):
                # appended replica: same RNG keys as the scalar oracle
                noise_a.append(_NoiseStream(
                    np.random.default_rng([seed, j, 1]),
                    physics.NOISE_SIGMA))
                noise_s.append(_NoiseStream(
                    np.random.default_rng([seed, j, 2]),
                    2 * physics.NOISE_SIGMA))
                arr_np.append(np.empty(0))
                arr_l.append([])
                jptr.append(0)
                busy.append(0.0)
                completed.append(0)
                done_flat.append([])
                wptr.append(0)
                shed_prev.append(False)
                dirty.add(instances[j].gpu)
            for i, inst in enumerate(instances):
                if inst.shed and not shed_prev[i]:
                    # shedding starts at this tick: reject the queued
                    # backlog (same set the oracle clears), keep the
                    # in-flight pass
                    j1 = bisect_right(arr_l[i], T, jptr[i])
                    if j1 > jptr[i]:
                        inst.shed_count += j1 - jptr[i]
                        jptr[i] = j1
                    completed[i] = jptr[i] - inst.shed_count
                    inst.completed = completed[i]
                    inst.queue = []
                shed_prev[i] = inst.shed
            n_inst = len(instances)
            for i in _resync_replicas(router, instances, arr_np, T):
                arr_l[i] = arr_np[i].tolist()
            moved = bool(new)
            for inst, old_g in changed:
                dirty.add(old_g)
                dirty.add(inst.gpu)
                moved = moved or old_g != inst.gpu
            if moved:
                by_gpu = _regroup(instances)
            if fstate is not None and changed:
                # migration of a fault-blocked backlog: see the scalar
                # twin — a no-op in clean runs, and with faults it pins
                # the first post-migration pass to the tick time
                pos = {id(inst): k for k, inst in enumerate(instances)}
                for inst, old_g in changed:
                    if old_g != inst.gpu:
                        k = pos[id(inst)]
                        if busy[k] < T:
                            busy[k] = T
        for g in sorted(dirty):
            if g in by_gpu:
                rebuild_gpu(g)
        if fstate is not None and T in fault_at:
            for (g, up) in fault_at[T]:
                if up:
                    resynced = fstate.on_restart(g, T, instances, by_gpu,
                                                 router, arr_np)
                else:
                    resynced = fstate.on_fail(g, T, instances, by_gpu,
                                              router, arr_np)
                for i in resynced:
                    arr_l[i] = arr_np[i].tolist()

    for i, inst in enumerate(instances):
        inst.completed = completed[i]
        inst.busy_until = busy[i]
        inst.queue = []
    rows.sort(key=lambda x: (x[0], x[1]))
    timeline = [row for (_, _, row) in rows]

    stats = _stats(sum(len(a) for a in arrivals), n_passes, peak_window,
                   wall0, n_reconfigs, adjust_wall_ms)
    if fstate is not None:
        stats.update(fstate.fault_stats(
            done_flat, horizon, sum(len(a) for a in arrivals),
            sum(completed)))
    _merge_overload_stats(adjust_fn, stats)
    return _finalize(instances, duration_s, timeline, stats)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def simulate_plan(plan: ProvisioningPlan,
                  models: Dict[str, ServedModelDesc],
                  hw: HardwareSpec, *,
                  duration_s: float = 30.0,
                  seed: int = 0,
                  poisson: bool = False,
                  shadow: bool = False,
                  shadow_extra: float = 0.10,
                  monitor_period_s: float = 0.5,
                  adjust_fn: Optional[AdjustFn] = None,
                  adjust_period_s: float = 1.0,
                  adjust_scope: str = "device",
                  record_timeline: bool = False,
                  trace: Optional["traces_mod.Trace"] = None,
                  faults: Optional["faults_mod.FaultSchedule"] = None,
                  telemetry: Optional["telemetry_mod.Telemetry"] = None,
                  engine: str = "vec",
                  backend: str = "torch",
                  device=None) -> SimResult:
    """Run the serving cluster for `duration_s` simulated seconds.

    ``engine="vec"`` (default) runs the table-cached epoch-major loop;
    ``engine="scalar"`` the reference global-heap loop.  Same seed =>
    byte-identical per-request latency streams across engines.

    ``backend="torch"`` (the default; vec engine only) evaluates the bulk
    latency-table builds on ``device`` through `physics_torch`: None ->
    cuda:0, raising without CUDA before any event runs
    (`repro_torch.device.resolve_device`); "cpu" runs the plain torch
    version when asked for by name.  Same event recurrence, table values
    within 1e-6 relative of the numpy oracle.  ``backend="numpy"`` (no
    ``device``) is the oracle, byte for byte the reference's; keep it for
    bitwise engine-identity checks and for ``engine="scalar"``.

    `adjust_fn` contract — IDENTICAL across engines (see `AdjustFn`):
    ``adjust_scope="device"`` (default) calls it once per device with
    that device's instances; ``adjust_scope="cluster"`` once per period
    with ALL instances (what the JAX package's `repro.serving.controller.Controller`
    needs).  The callback may mutate r / batch / shadow_r / gpu;
    queue / latencies / busy_until / completed / recent_arrivals are
    synced read-only views in both engines.

    ``trace`` replaces the constant arrival rates with a
    `repro_torch.serving.traces.Trace` schedule (diurnal / spike / churn);
    arrivals stay pre-generated from the shared per-instance RNG
    streams, so traced runs remain engine-identical.

    ``faults`` injects a `repro_torch.serving.faults.FaultSchedule` — device
    down intervals (in-flight passes finish, backlog queues, replica
    groups absorb the dead replica's share, a ``restart`` of ``inf``
    loses the backlog) and persistent straggler multipliers the
    performance model never sees.  Fault runs stay byte-identical
    across engines; ``SimResult.stats`` gains ``n_failures`` /
    ``downtime_ms`` / ``lost_requests`` / ``n_recoveries`` /
    ``recovery_mean_ms``.  ``faults=None`` leaves every code path —
    and every output byte — exactly as before.

    ``telemetry`` attaches a `repro_torch.serving.telemetry.Telemetry`
    recorder: per-monitor-tick workload/device metric timelines and one
    typed ``reconfig`` event per placement mutation at adjust ticks
    (see `docs/observability.md`).  ``telemetry=None`` (default) is
    byte-identical to not having the feature at all, and for a fixed
    seed both engines record identical event/timeline content (host
    wall-time fields excepted).
    """
    if adjust_scope not in ("device", "cluster"):
        raise ValueError(f"unknown adjust_scope {adjust_scope!r}")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "numpy" and device is not None:
        raise ValueError("device= applies to backend='torch'; the numpy "
                         f"backend runs on the host (got {device!r})")
    kwargs = dict(duration_s=duration_s, seed=seed, poisson=poisson,
                  shadow=shadow, shadow_extra=shadow_extra,
                  monitor_period_s=monitor_period_s, adjust_fn=adjust_fn,
                  adjust_period_s=adjust_period_s,
                  record_timeline=record_timeline,
                  adjust_scope=adjust_scope, trace=trace, faults=faults,
                  telemetry=telemetry)
    if engine == "vec":
        dev = resolve_device(device) if backend == "torch" else None
        return _simulate_vec(plan, models, hw, backend=backend, device=dev,
                             **kwargs)
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    if backend != "numpy":
        raise ValueError("backend='torch' requires engine='vec' (the scalar "
                         "oracle is numpy by definition)")
    return _simulate_scalar(plan, models, hw, **kwargs)


def simulate_full(plan: ProvisioningPlan,
                  models: Dict[str, ServedModelDesc],
                  hw: HardwareSpec, *,
                  duration_s: float = 10.0,
                  seed: int = 0,
                  **kwargs) -> SimResult:
    """Full-cluster ground-truth simulation: EVERY device of the plan
    (m=1000 => ~461 devices), vectorized engine.  `SimResult.stats`
    carries n_requests / n_passes / events_per_s for the scale sweep —
    this is the closed loop that turns `predicted_violations` into a
    comparison against simulated ground truth."""
    return simulate_plan(plan, models, hw, duration_s=duration_s, seed=seed,
                         **kwargs)


def subplan(plan: ProvisioningPlan, device_ids: Sequence[int]
            ) -> ProvisioningPlan:
    """Restrict a plan to a subset of devices.

    Devices are independent in the simulator (co-location physics only
    couples workloads on the SAME device), so simulating a subset is a
    faithful sample of the full cluster for the workloads it hosts —
    and with per-instance RNG streams keyed by the instance's position
    in the (sub)plan, what made spot-checking tractable before
    `simulate_full` existed.
    """
    keep = set(int(g) for g in device_ids)
    out = ProvisioningPlan(hardware=plan.hardware)
    out.placements = [p for p in plan.placements if p.gpu in keep]
    out.n_gpus = len({p.gpu for p in out.placements})
    return out


def simulate_device_sample(plan: ProvisioningPlan,
                           models: Dict[str, ServedModelDesc],
                           hw: HardwareSpec, *,
                           max_devices: int = 8,
                           duration_s: float = 10.0,
                           seed: int = 0,
                           **kwargs) -> Tuple[SimResult, List[int]]:
    """Simulate a uniform sample of devices from a large plan and return
    (result, sampled device ids).  Superseded by `simulate_full` for CI
    validation (the vec engine makes the full cluster affordable); kept
    for quick spot checks and as API surface for notebooks."""
    rng = np.random.default_rng(seed)
    gpus = sorted({p.gpu for p in plan.placements})
    if len(gpus) > max_devices:
        gpus = sorted(rng.choice(gpus, size=max_devices, replace=False))
    sub = subplan(plan, gpus)
    res = simulate_plan(sub, models, hw, duration_s=duration_s, seed=seed,
                        **kwargs)
    return res, [int(g) for g in gpus]


def measure_steady(entries, models, hw):
    """GSLICE's measurement callback: steady-state avg latency + achievable
    throughput for each entry co-located on one device."""
    ds = [(models[e[0].model], e[2], e[3]) for e in entries]
    sts = physics.device_state(ds, hw)
    out = []
    for e, st in zip(entries, sts):
        b = e[2]
        thr = 1000.0 * b / (st.t_gpu + st.t_feedback)
        out.append((st.t_inf, thr))
    return out
