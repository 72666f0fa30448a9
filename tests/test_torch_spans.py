"""The serving pass's per-pass log (``repro_torch.profiling.spans``) on the
CPU: one record per pass, four contiguous phases, a bounded ring that
counts what it dropped, and no record for a pass whose dispatch was never
stamped."""
import time

import numpy as np
from repro_torch.profiling import spans
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.telemetry import RingBuffer

from tests._torch_spans import B, engine, mine, submit


def test_one_record_per_pass_with_its_rows_batch_and_queue():
    eng = engine()
    submit(eng, 5)
    before = spans.passes().total
    while eng.queue:
        eng.pump()
    assert eng.pump() == []                       # an empty queue makes no pass
    recs = mine(eng)
    assert spans.passes().total - before == len(recs) == 3
    assert [r.rows for r in recs] == [2, 2, 1]
    assert [r.queued for r in recs] == [5, 3, 1]
    assert [r.oldest_arrival_s for r in recs] == [1000.0, 1002.0, 1004.0]
    assert all(r.batch_size == B and r.device == "cpu" for r in recs)


def test_four_contiguous_phases_sum_to_the_pass():
    eng = engine()
    submit(eng, 4)
    t = time.time_ns()
    while eng.queue:
        eng.pump()
    for r in mine(eng):
        assert list(r.stamps_ns) == sorted(r.stamps_ns) and r.start_ns >= t
        ph = r.phase_ns()
        assert tuple(ph) == spans.PHASES
        assert sum(ph.values()) == r.end_ns - r.start_ns
        assert ph["engine.dispatch"] > 0


def test_the_ring_keeps_its_capacity_and_counts_what_it_dropped(monkeypatch):
    ring = RingBuffer(3)
    monkeypatch.setattr(spans, "_PASSES", ring)
    eng = engine(decode_tokens=1)
    submit(eng, 2 * 5)
    while eng.queue:
        eng.pump()
    assert spans.passes() is ring
    assert (ring.capacity, len(ring), ring.total, ring.dropped) == (3, 3, 5, 2)
    assert [r.queued for r in ring] == [6, 4, 2]          # the newest three


def test_a_pass_whose_dispatch_was_never_stamped_is_not_recorded(monkeypatch):
    """A ``_serve`` replaced without calling the engine's own leaves the
    split between dispatch and fetch unknown: no record, rather than one
    with a stale stamp.  A wrapper that calls it is recorded."""
    eng = engine()
    serve = ServingEngine._serve
    monkeypatch.setattr(ServingEngine, "_serve",
                        lambda self, tokens: np.zeros((B, 2), np.int32))
    submit(eng, 2)
    assert len(eng.pump()) == 2 and mine(eng) == []
    monkeypatch.setattr(ServingEngine, "_serve", lambda self, tokens: serve(self, tokens))
    submit(eng, 2)
    assert len(eng.pump()) == 2 and len(mine(eng)) == 1
