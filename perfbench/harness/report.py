"""The result line and the check's last lines.

Standard output's last line is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` and, traced, ``breakdown``; then what
helps a reader (the program's launch counters, pumps, how late the
generator woke, the card and its power limit); ``checks`` last, each
number compared beside its limit.  The same numbers end standard error.
"""
from __future__ import annotations

import json
import sys
from typing import Dict


class NoDeviceTime(RuntimeError):
    """A traced run in which the profiler saw no device operation."""


def line(res: Dict, kind: str, count: int, traced: bool, card: str) -> Dict:
    trace = res.get("trace")
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if traced:
        if not trace or trace["busy_s"] <= 0:
            raise NoDeviceTime("the profiler recorded no device operation in the traced window")
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if traced:
        out["breakdown"] = trace["breakdown"]
    out["launches"] = res["launches"]
    out["pumps"] = res["pumps"]
    out["card"] = card
    out["checks"] = res["checks"]
    return out


def emit(out: Dict, stdout=None, stderr=None):
    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=stderr)
    stderr.flush()
    print(json.dumps(out), file=stdout, flush=True)
