"""Arithmetic of the readers of the program's per-pass log
(``repro_torch.profiling.spans.passes()``): the serving passes' phases, on
the program's own ``time.time_ns()`` stamps.  A program without the log
reads None, as does a CPU engine's, whose host computes the pass itself
(its dispatch holds the computation, its fetch only a copy)."""
from __future__ import annotations

from typing import List, Optional


def window_passes(run) -> Optional[List]:
    """The log's records of the pumps the host-clock metrics read
    (``Run.host_pumps``): started at or after the window's start and ended
    by ``run.host_end()``.  None where the program keeps no per-pass log."""
    try:
        from repro_torch.profiling import spans
    except ImportError:
        return None
    lo, hi = run.window.t0 * 1e9, run.host_end() * 1e9
    return [r for r in spans.passes() if r.start_ns >= lo and r.end_ns <= hi]


def phase_ms(run, *phases: str) -> Optional[float]:
    """The phases' summed length, its mean over ``window_passes``, in ms;
    None unless the log holds one record for each pump ``Run.host_pumps``
    keeps (a log that overflowed, or a pass left unrecorded, would
    otherwise average a subset)."""
    recs = window_passes(run)
    if (not recs or len(recs) != len(run.host_pumps())
            or any(r.device == "cpu" for r in recs)):
        return None
    return sum(r.phase_ns()[p] for r in recs for p in phases) / len(recs) / 1e6
