"""Opt-in observability: control-plane event tracing, metric timelines,
drift series, and Sec. 5.5-style overhead accounting.

One `Telemetry` object is threaded (``telemetry=`` keyword, default
``None``) through the simulator (both engines), the controller stack
(`Controller` / `Reconciler` / `HealthMonitor`), and the provisioner
edit ops.  It records four streams into bounded ring buffers:

* **events** — every control-plane decision (resize / migrate / split /
  merge / quarantine / evict-migrate / readmit / preempt / brownout /
  shed / admit / capped / reconfig) as a typed `ControlEvent` carrying
  the cause, the estimator inputs that drove it (rate / trend / CV^2,
  hysteresis bands), the pre/post placement of the touched workload,
  and the tick's controller wall time;
* **workloads / devices** — per-monitor-tick metric timelines:
  per-workload p99 / avg / rps / queue-wait, and per-device utilization,
  effective batch, and the interference terms of the true physics
  (Sigma-power, Sigma-cache, Delta_sch, DVFS frequency — the
  `VecCluster` analogues, evaluated noise-free);
* **drift** — the measured-vs-fitted residual series the
  `HealthMonitor` computes per device (raw median ratio, fleet-
  normalized score, fleet median) — the signal quarantine decisions
  are made from;
* **counters / walls / gauges** — overhead profiling: per-phase
  controller wall (probe / solve / apply), `ProbeCache` hits/misses,
  provisioner-op and jit-vs-numpy dispatch counts.

Hard contracts (pinned by `tests/test_telemetry.py`):

* ``telemetry=None`` is byte-identical to the pre-telemetry build —
  every hook is behind ``if telemetry is not None``;
* for a fixed seed, the scalar and vec engines emit IDENTICAL event
  and timeline content (wall-time fields excepted — they measure the
  host, not the simulation).  Timeline rows are therefore computed
  with pure-Python arithmetic from values both engines share, and the
  device interference snapshot is evaluated through the same bucketed
  `physics.device_state_arrays` path for both;
* counter names prefixed ``dispatch_`` / ``prov_`` are engine- or
  path-specific by design and excluded from the identity contract;
* `benchmarks/dynamic_sweep.py --telemetry --check` bounds telemetry-on
  wall overhead at m=1000 to <= 10% over telemetry-off.

Exporters: `Telemetry.to_jsonl` (one typed record per line + a summary
trailer), `Telemetry.prometheus_text` (text-format snapshot), and
`benchmarks/telemetry_report.py` (self-contained HTML / terminal
timeline report rendered FROM the JSONL, stdlib-only).

A verbatim copy of the JAX package's ``repro.serving.telemetry``; its
`sample_tick` evaluates the numpy `physics.device_state_arrays` on the
host, as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import HardwareSpec
from repro_torch.serving import physics

__all__ = ["RingBuffer", "ControlEvent", "Telemetry", "DEFAULT_RETENTION"]

DEFAULT_RETENTION = 4096     # rows kept per ring (events / timelines)


class RingBuffer:
    """Bounded append-only buffer: keeps the newest ``capacity`` rows,
    counts everything ever appended (``total``) so overflow is visible
    (``dropped``) instead of silent."""

    __slots__ = ("_dq", "total")

    def __init__(self, capacity: int = DEFAULT_RETENTION):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._dq: deque = deque(maxlen=int(capacity))
        self.total = 0

    @property
    def capacity(self) -> int:
        return self._dq.maxlen

    @property
    def dropped(self) -> int:
        return self.total - len(self._dq)

    def append(self, row) -> None:
        self._dq.append(row)
        self.total += 1

    def __len__(self) -> int:
        return len(self._dq)

    def __iter__(self) -> Iterator:
        return iter(self._dq)

    def __getitem__(self, i):
        return self._dq[i]

    def list(self) -> list:
        return list(self._dq)


@dataclass
class ControlEvent:
    """One typed control-plane decision.

    ``kind`` is the decision type: the `PlanEdit` actions (resize /
    remove / add / split / merge / infeasible / migrate / readmit /
    preempt / shed / admit / capped / forecast / shadow_arm /
    shadow_disarm — the last three are the predictive tier's pre-size
    and Sec. 4.2 reservation lifecycle) plus ``quarantine`` (health
    layer), ``brownout`` (admission layer), and ``reconfig``
    (simulator-side: one per instance whose placement tuple actually
    changed at an adjust tick).  ``cause`` groups kinds by driving
    signal: "drift" (estimator band breach), "health", "admission",
    "arrival", "departure", "adjust", "scale_out", "forecast".

    Estimator fields are 0.0 when no estimator drove the decision
    (health / simulator events).  ``pre`` / ``post`` are tuples of
    ``(gpu, batch, r)`` per replica — ``None`` when not applicable.
    ``wall_ms`` is host wall time (the tick's solve wall for controller
    events); it is EXCLUDED from the engine-identity contract.
    """
    t_s: float
    kind: str
    workload: str
    cause: str = ""
    rate_from: float = 0.0
    rate_to: float = 0.0
    burstiness: float = 0.0
    replicas: int = 1
    # estimator inputs at decision time
    rate_rps: float = 0.0
    trend_rps: float = 0.0
    cv2: float = 0.0
    projected_rps: float = 0.0
    rate_sigma: float = 0.0
    band_up: float = 0.0
    band_down: float = 0.0
    # placement delta
    pre: Optional[Tuple[Tuple[int, int, float], ...]] = None
    post: Optional[Tuple[Tuple[int, int, float], ...]] = None
    gpu_from: int = -1
    gpu_to: int = -1
    wall_ms: float = 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["pre"] = None if self.pre is None else [list(p) for p in self.pre]
        d["post"] = (None if self.post is None
                     else [list(p) for p in self.post])
        return d


def _p99(window: Sequence[float]) -> float:
    """np.percentile(window, 99) (the default 'linear' interpolation)
    in pure Python — per-instance-per-tick numpy calls dominated the
    telemetry overhead budget at m=1000."""
    n = len(window)
    if n == 0:
        return 0.0
    s = sorted(window)
    if n == 1:
        return float(s[0])
    pos = 0.99 * (n - 1)
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= n:
        return float(s[-1])
    return float(s[lo] + frac * (s[lo + 1] - s[lo]))


class Telemetry:
    """The recorder.  Construct one per run and pass it everywhere the
    ``telemetry=`` keyword exists; ``retention`` bounds every ring.

    The hooks are written so that ALL cost is skipped when the object
    is absent — the callers guard with ``if telemetry is not None`` and
    never build intermediate state otherwise.
    """

    def __init__(self, retention: int = DEFAULT_RETENTION):
        self.retention = int(retention)
        self.events = RingBuffer(self.retention)       # ControlEvent
        self.workloads = RingBuffer(self.retention)    # dict rows
        self.devices = RingBuffer(self.retention)      # dict rows
        self.drift = RingBuffer(self.retention)        # dict rows
        self.counters: Dict[str, int] = {}
        self.walls: Dict[str, float] = {}              # name -> total ms
        self.gauges: Dict[str, float] = {}

    # -- scalars ------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def add_wall(self, name: str, ms: float) -> None:
        self.walls[name] = self.walls.get(name, 0.0) + ms

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # -- events -------------------------------------------------------------

    def record_event(self, ev: ControlEvent) -> None:
        self.events.append(ev)
        self.count("events_" + ev.kind)
        if ev.kind == "reconfig":
            # overflow-immune: the n_reconfigs reconciliation gate must
            # survive the ring dropping old rows
            self.count("reconfig_events")

    # -- drift series (HealthMonitor) ---------------------------------------

    def record_drift(self, t_s: float, gpu: int, raw: float,
                     score: float, fleet: float) -> None:
        """One device's measured/fitted residual at a control tick:
        ``raw`` is the median measured/predicted service-time ratio,
        ``score`` the leave-one-out fleet-normalized residual (0.0 when
        the device could not be scored), ``fleet`` the fleet median of
        scores — exactly the triple quarantine decisions compare."""
        self.drift.append({"t_s": t_s, "gpu": int(gpu), "raw": float(raw),
                           "score": float(score), "fleet": float(fleet)})

    # -- metric timelines (simulator monitor ticks) -------------------------

    def sample_tick(self, t_ms: float, instances, by_gpu, hw: HardwareSpec,
                    rows: List[Tuple[int, Sequence[float], Sequence[float],
                                     Sequence[float], int]]) -> None:
        """Record one monitor tick.  ``rows`` holds, per instance index,
        ``(i, window_latencies, window_waits, window_done_stamps,
        queue_len)`` — values BOTH engines derive identically from the
        shared completion streams, so the recorded timelines are
        engine-identical by construction.  All per-row arithmetic is
        pure Python (see `_p99`); the device interference snapshot is
        one bucketed `physics.device_state_arrays` call per co-location
        width, mirroring the vec engine's `_build_tables_bulk` grouping.
        """
        t_s = t_ms / 1000.0
        per_inst: Dict[int, Tuple[int, int, int]] = {}
        for (i, window, waits, stamps, qlen) in rows:
            inst = instances[i]
            k = len(window)
            passes = 0
            prev = None
            for d in stamps:
                if d != prev:
                    passes += 1
                    prev = d
            per_inst[i] = (k, passes, qlen)
            self.workloads.append({
                "t_s": t_s, "workload": inst.spec.name,
                "p99_ms": _p99(window),
                "avg_ms": (sum(window) / k) if k else 0.0,
                "rps": float(k),
                "wait_avg_ms": (sum(waits) / k) if k else 0.0,
                "queue": int(qlen),
                "r": inst.r_eff, "batch": inst.batch,
                "shed": bool(inst.shed),
            })
        self._sample_devices(t_s, instances, by_gpu, hw, per_inst)

    def _sample_devices(self, t_s: float, instances, by_gpu,
                        hw: HardwareSpec, per_inst) -> None:
        gpus = sorted(by_gpu)
        buckets: Dict[int, List[int]] = {}
        for g in gpus:
            buckets.setdefault(len(by_gpu[g]), []).append(g)
        for n, gs in sorted(buckets.items()):
            R = len(gs)
            b = np.empty((R, n))
            r = np.empty((R, n))
            consts = [np.empty((R, n)) for _ in range(6)]
            d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern = consts
            for row, g in enumerate(gs):
                for j, i in enumerate(by_gpu[g]):
                    inst = instances[i]
                    b[row, j] = max(1, inst.batch)
                    r[row, j] = inst.r_eff
                    dsc = inst.desc
                    d_load[row, j] = dsc.d_load_mb
                    d_fb[row, j] = dsc.d_feedback_mb
                    flops_i[row, j] = dsc.flops_per_item
                    w_bytes[row, j] = dsc.weight_bytes
                    a_bytes[row, j] = dsc.act_bytes_per_item
                    n_kern[row, j] = float(dsc.n_kernels)
            st = physics.device_state_arrays(
                d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r,
                n, hw)
            power_sum = st.power.sum(axis=-1)
            cache_sum = st.cache_util.sum(axis=-1)
            delta_sch = (0.0 if n <= 1
                         else hw.alpha_sch * n + hw.beta_sch)   # Eq. 6
            for row, g in enumerate(gs):
                comp = passes = qsum = 0
                util = 0.0
                for i in by_gpu[g]:
                    util += instances[i].r_eff
                    k, p, q = per_inst.get(i, (0, 0, 0))
                    comp += k
                    passes += p
                    qsum += q
                self.devices.append({
                    "t_s": t_s, "gpu": int(g), "n_colocated": n,
                    "util": util, "queue": qsum,
                    "completions": comp,
                    "eff_batch": (comp / passes) if passes else 0.0,
                    "power_sum": float(power_sum[row]),
                    "cache_sum": float(cache_sum[row]),
                    "delta_sch": float(delta_sch),
                    "freq": float(st.freq[row]),
                    "device_power": float(st.device_power[row]),
                })

    # -- exporters ----------------------------------------------------------

    def summary(self) -> Dict:
        return {
            "counters": dict(sorted(self.counters.items())),
            "walls_ms": {k: round(v, 3)
                         for k, v in sorted(self.walls.items())},
            "gauges": dict(sorted(self.gauges.items())),
            "rings": {name: {"rows": len(ring), "total": ring.total,
                             "dropped": ring.dropped}
                      for name, ring in (("events", self.events),
                                         ("workloads", self.workloads),
                                         ("devices", self.devices),
                                         ("drift", self.drift))},
        }

    def to_jsonl(self, path: str) -> None:
        """One typed record per line: ``{"type": "event" | "workload" |
        "device" | "drift" | "summary", ...}``.  The summary trailer is
        last, so `benchmarks/telemetry_report.py` can stream-parse."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps({"type": "event", **ev.to_dict()}))
                f.write("\n")
            for name, ring in (("workload", self.workloads),
                               ("device", self.devices),
                               ("drift", self.drift)):
                for row in ring:
                    f.write(json.dumps({"type": name, **row}))
                    f.write("\n")
            f.write(json.dumps({"type": "summary", **self.summary()}))
            f.write("\n")

    def prometheus_text(self) -> str:
        """Text-format metrics snapshot (counters, wall totals, gauges,
        ring fill) — the pull-scrape view of the same state."""
        lines = []

        def emit(name, mtype, items):
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(items)

        emit("repro_telemetry_count", "counter",
             [f'repro_telemetry_count{{name="{k}"}} {v}'
              for k, v in sorted(self.counters.items())])
        emit("repro_telemetry_wall_ms", "counter",
             [f'repro_telemetry_wall_ms{{phase="{k}"}} {v:.3f}'
              for k, v in sorted(self.walls.items())])
        emit("repro_telemetry_gauge", "gauge",
             [f'repro_telemetry_gauge{{name="{k}"}} {v}'
              for k, v in sorted(self.gauges.items())])
        emit("repro_telemetry_ring_rows", "gauge",
             [f'repro_telemetry_ring_rows{{ring="{name}"}} {len(ring)}'
              for name, ring in (("events", self.events),
                                 ("workloads", self.workloads),
                                 ("devices", self.devices),
                                 ("drift", self.drift))])
        return "\n".join(lines) + "\n"
