"""Arithmetic the metric readers (``metrics/<name>.py``) share.  Each
returns None where its run holds nothing to read: no traced window, no
pump, no device time in the group.  Host-clock readings take
``Run.host_pumps``: in a traced run, the pumps before recording began."""
from __future__ import annotations

from typing import Optional


def pass_ms(run) -> Optional[float]:
    pumps = run.host_pumps()
    return sum(p.end - p.start for p in pumps) / len(pumps) * 1e3 if pumps else None


def _traced(run):
    t = run.trace
    return t["pumps"] if t and t["busy_s"] > 0 and t["pumps"] else None


def roofline(run, group: str) -> Optional[float]:
    """The group's least time for the traced passes' real rows (operations
    at the peak rate or bytes at the peak bandwidth, whichever is longer)
    over its device time, in %.  Where the profiler dropped some of a
    port kernel's records, its time is its kept records' mean times its
    launches a pass (``flops/<family>.launches``)."""
    pumps = _traced(run)
    if pumps is None:
        return None
    want = run.flops.launches(run.sz).get(group)
    flops = nbytes = seconds = 0.0
    for p in pumps:
        if p["group_launches"][group] == 0:
            continue
        f, b = run.counts(p["rows"], group)
        flops, nbytes = flops + f, nbytes + b
        t = p["group_s"][group]
        seconds += t * want / p["group_launches"][group] if want else t
    if seconds <= 0:
        return None
    least = max(flops / run.peaks["flops_per_s"], nbytes / run.peaks["bytes_per_s"])
    return 100.0 * least / seconds


def group_ms_per_pass(run, group: str) -> Optional[float]:
    pumps = _traced(run)
    if pumps is None:
        return None
    return sum(p["group_s"][group] for p in pumps) / len(pumps) * 1e3


def idle_share(run) -> Optional[float]:
    """Share of the traced window with no device operation, in %."""
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _useful_flops(run, pumps) -> float:
    return sum(run.counts(p.rows, "total")[0] for p in pumps)


def mfu_window(run) -> Optional[float]:
    """Useful flops completed in the window over its length, as a share of
    the peak rate, in %."""
    span = run.host_end() - run.window.t0
    if span <= 0:
        return None
    return 100.0 * _useful_flops(run, run.host_pumps()) / span / run.peaks["flops_per_s"]
