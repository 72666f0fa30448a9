"""The traced run: torch.profiler over part of the window, reduced to
device time by kernel group, busy and idle time, and a breakdown.

The grouping is a frozen copy of ``chip_smoke.kernel_groups``: the port's
kernels by name, cuBLAS and CUTLASS products (``gemm`` / ``gemv`` /
``cutlass``) as ``matmul``, everything else (elementwise and other ATen
kernels, copies) as ``other``.  The idle arithmetic is
``chip_smoke.profile_pump``'s: the share of a span in which no device
operation ran, here from the union of the operations' intervals.

The profiler starts between two pumps ``start_s`` into the window and
records for ``length_s``; the harness's span ``bench.pump`` marks the
host's work in it.  Its start stalls the host
and recording slows the host's dispatch, so a traced run reads its
host-clock metrics from the pumps that ended before the profiler started
(``bench.Run.host_pumps``), its device metrics from the recorded ones,
and never an end-to-end metric.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional

import torch

KERNEL_GROUPS = {"flash_attn_kernel": "flash_attention", "decode_attn": "decode_attention",
                 "rwkv6_scan_kernel": "rwkv6_scan", "ssd_scan_kernel": "ssd_scan"}
GROUPS = (*KERNEL_GROUPS.values(), "matmul", "other")
WINDOW, PUMP = "bench.traced", "bench.pump"
TOP = 10
NAME_CHARS = 160


def group_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    for key, group in KERNEL_GROUPS.items():
        if key in name:
            return group
    if "gemm" in name or "gemv" in name or "cutlass" in name:
        return "matmul"
    return "other"


class NoTracer:
    active = False
    started = None

    def poll(self, elapsed_s: float):
        pass

    def span(self, name: str):
        return contextlib.nullcontext()

    def stop(self):
        pass


class Tracer:
    """Profiles from ``start_s`` to ``start_s + length_s`` of the window,
    switching only between pumps (``poll``)."""

    def __init__(self, start_s: float, length_s: float, device_type: str):
        self.start_s, self.stop_s = start_s, start_s + length_s
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device_type = device_type
        # made now, started only at ``start_s``: a running profiler slows
        # the host's dispatch even before it records
        self.prof = torch.profiler.profile(activities=acts)
        self.active = False
        self.done = False
        self.started = None             # time.time() when recording began
        self._window = None

    def poll(self, elapsed_s: float):
        if not self.active and not self.done and elapsed_s >= self.start_s:
            self.prof.start()
            if self.device_type == "cuda":
                # an H100 profiler run may drop its first kernel records
                # (chip_smoke.device_ms): keep the card busy first
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
            self._window = torch.profiler.record_function(WINDOW)
            self._window.__enter__()
            self.active = True
            self.started = time.time()
        elif self.active and elapsed_s >= self.stop_s:
            self.stop()

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def stop(self):
        if self.active:
            self._window.__exit__(None, None, None)
            self.active = False
        if not self.done:
            if self.started is not None:
                self.prof.stop()
            self.done = True


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, lo, hi):
    """Length of [lo, hi) covered by the sorted, disjoint ``merged``."""
    i = max(0, bisect.bisect_right(merged, [lo, float("inf")]) - 1)
    total = 0.0
    for s, e in merged[i:]:
        if s >= hi:
            break
        total += max(0.0, min(e, hi) - max(s, lo))
    return total


def _innermost(cpu_events, points):
    """For each time in ``points`` (sorted), the name of the innermost host
    span containing it (spans of one thread, properly nested), or
    ``"host: no span"``."""
    evs = sorted(cpu_events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(evs) and evs[i][0] <= t:
            s, e, name = evs[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: no span")
    return out


def _raw_events(prof):
    """(start_ns, end_ns, name, on_device, thread) of every event, read
    from kineto's records (``prof.events()`` builds a tree of them, some
    sixty times slower).  Device-side copies of the harness's spans
    (user annotations) are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if on_device and (annotation or e.name().startswith("bench.")):
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), on_device,
                    e.start_thread_id()))
    return out


def summarize(tracer: Tracer, pump_rows: List[int]) -> Optional[Dict]:
    """Reduce the traced window. ``pump_rows``: the real rows of each pump
    the tracer marked, in order.  Returns None where the profiler saw no
    window.  Times in the profiler's nanoseconds until the seconds out."""
    tracer.stop()
    if tracer.started is None:              # the window closed before recording began
        return None
    events = _raw_events(tracer.prof)
    win = next((e for e in events if e[2] == WINDOW and not e[3]), None)
    if win is None:
        return None
    lo, hi, thread = win[0], win[1], win[4]
    dev = [(s, e, n) for s, e, n, on_dev, _ in events if on_dev and lo <= s < hi]
    host = [(s, e, n) for s, e, n, on_dev, th in events
            if not on_dev and th == thread and n != WINDOW and e > lo and s < hi]
    pumps = sorted((s, e) for s, e, n in host if n == PUMP)
    if len(pumps) != len(pump_rows):
        raise RuntimeError(f"trace: {len(pumps)} pump spans for {len(pump_rows)} traced pumps")
    merged = _merge([(s, e) for s, e, _ in dev])
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    dev.sort()
    starts = [s for s, _, _ in dev]
    per_pump, group = [], {}
    for (ps, pe), rows in zip(pumps, pump_rows):
        groups = dict.fromkeys(GROUPS, 0.0)
        counts = dict.fromkeys(GROUPS, 0)
        for s, e, n in dev[bisect.bisect_left(starts, ps):bisect.bisect_left(starts, pe)]:
            g = group.setdefault(n, group_of(n))
            groups[g] += (e - s) / 1e9
            counts[g] += 1
        per_pump.append({"rows": rows, "wall_s": (pe - ps) / 1e9,
                         "busy_s": _overlap(merged, ps, pe) / 1e9,
                         "group_s": groups, "group_launches": counts})
    gaps, prev = [], lo
    for s, e in merged + [[hi, hi]]:
        s = max(s, lo)
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, min(e, hi))
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    idle: Dict[str, float] = {}
    for (a, b), n in zip(gaps, names):
        idle[n] = idle.get(n, 0.0) + (b - a) / 1e9
    top = lambda d: [[k[:NAME_CHARS], v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (hi - lo) / 1e9, "busy_s": _overlap(merged, lo, hi) / 1e9,
            "device_ops": len(dev), "pumps": per_pump,
            "breakdown": {"device_ops": top({k: v / 1e9 for k, v in by_name.items()}),
                          "idle_gaps": top(idle)}}
