"""The serving pass's own timing: a bounded per-pass log, always on, and
profiler spans, only while a profiler records.

``ServingEngine.pump`` appends one ``PassRecord`` per serving pass to the
process-wide log that ``passes()`` returns, a
``serving.telemetry.RingBuffer`` of the newest ``PASS_LOG_CAPACITY``
passes whose ``dropped`` counts what overflow pushed out.  Five
``time.time_ns()`` stamps bound the pass's four contiguous phases:

- ``engine.take``: popping the queue and padding the prompts into numpy;
- ``engine.dispatch``: the copy to the device, the cache's reset, the
  prefill, the argmax, any decode steps and the concatenation: every launch
  of the pass (on the CPU, the pass's whole computation);
- ``engine.fetch``: ``.cpu().numpy()``, the host blocked until the device
  finishes the pass, then the copy back;
- ``engine.complete``: building the completions and their latencies.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
records and a shared no-op context otherwise.  The engine's phases and
the served model's ``model.embed``, ``model.mix`` (each block's mixer
with its norm), ``model.ffn`` (each block's MLP or channel mix with its
norm) and ``model.head`` use it.  The profiler stamps host events on the
``time.time_ns()`` clock, so a trace's spans line up with the log's
stamps.

``graph_counts()`` counts what ``Model.prefill`` did with each call
(``models/graphs.py``): ``captured``, a key's first call, run eagerly and
then captured as a CUDA graph; ``replayed``, a later call of that key,
replayed under the span ``model.graph.replay``; ``eager``, a call that is
not eligible (off the card, under autograd, on a mesh) or whose key's
capture failed.  Under replay the ``model.*`` spans of the blocks are not
emitted: the graph's kernels run inside ``model.graph.replay``.

The module imports only torch: the model imports ``span`` from it, and the
serving layer's ``RingBuffer`` is imported when the log is first read or
written, which is the engine's first pass.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

if TYPE_CHECKING:
    from repro_torch.serving.telemetry import RingBuffer

__all__ = ["PHASES", "PASS_LOG_CAPACITY", "PassRecord", "passes", "span", "graph_counts",
           "reset_graph_counts"]

PHASES = ("engine.take", "engine.dispatch", "engine.fetch", "engine.complete")
PASS_LOG_CAPACITY = 4096        # about four minutes of passes at 16 a second

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else a no-op
    (one read of the profiler's Python-side flag)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclasses.dataclass(slots=True)
class PassRecord:
    """One serving pass.  ``stamps_ns``: five ``time.time_ns()`` readings,
    the pass's start, the ends of ``take``, ``dispatch`` and ``fetch``, and
    its end."""
    engine: int                   # the engine's id within the process
    device: str                   # the engine's device type: "cuda" or "cpu"
    rows: int                     # real requests served
    batch_size: int               # rows after padding
    queued: int                   # queue depth before the take
    oldest_arrival_s: float       # the oldest taken request's arrival_s
    stamps_ns: Tuple[int, int, int, int, int]

    @property
    def start_ns(self) -> int:
        return self.stamps_ns[0]

    @property
    def end_ns(self) -> int:
        return self.stamps_ns[-1]

    def phase_ns(self) -> Dict[str, int]:
        """Each phase's length, in ``PHASES`` order; they sum to
        ``end_ns - start_ns``."""
        s = self.stamps_ns
        return {name: s[i + 1] - s[i] for i, name in enumerate(PHASES)}


_PASSES: Optional["RingBuffer"] = None


def passes() -> "RingBuffer":
    """The process's per-pass log, oldest first."""
    global _PASSES
    if _PASSES is None:
        from repro_torch.serving.telemetry import RingBuffer
        _PASSES = RingBuffer(PASS_LOG_CAPACITY)
    return _PASSES


def record(rec: PassRecord) -> None:
    passes().append(rec)


GRAPH_OUTCOMES = ("captured", "replayed", "eager")
_GRAPHS = dict.fromkeys(GRAPH_OUTCOMES, 0)


def graph_counts() -> Dict[str, int]:
    """``Model.prefill``'s calls since the last reset, by outcome:
    ``captured``, ``replayed``, ``eager``."""
    return dict(_GRAPHS)


def reset_graph_counts() -> None:
    _GRAPHS.update(dict.fromkeys(GRAPH_OUTCOMES, 0))


def count_graph(outcome: str) -> None:
    _GRAPHS[outcome] += 1
