"""The measured window: the cell's requests through ``ServingEngine.submit``
and ``pump``, one process, one thread.

A closed loop: ``clients`` callers, each sending its next request when its
last is answered, so every pass is a full batch.  The window runs from the
first submission to the end of the last pump that started inside
``seconds`` (a pump ends when the tokens reach the host); the callers'
outstanding requests are then drained, outside the window.

``LogitsTap`` stands in for the engine's ``model`` and hands each
prefill's last-position logits to the ``Keeper``, so the check can compare
what the timed passes produced; it changes no call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from .tracing import PUMP
from .traffic import SAMPLE_STREAM

DRAIN_LIMIT_S = 60.0        # how long after the close an answer is waited for


class LogitsTap:
    def __init__(self, model):
        self._model = model
        self.fresh: List = []

    def prefill(self, *args, **kwargs):
        logits, cache = self._model.prefill(*args, **kwargs)
        self.fresh.append(logits)
        return logits, cache

    def take(self) -> List:
        out, self.fresh = self.fresh, []
        return out

    def __getattr__(self, name):
        return getattr(self._model, name)


@dataclasses.dataclass
class Pump:
    start: float
    end: float
    rows: int
    traced: bool


@dataclasses.dataclass
class Answer:
    done: float           # end of the pump that served it
    token: np.ndarray
    pump: int
    row: int


@dataclasses.dataclass
class Window:
    t0: float
    close: float              # end of the last pump that started in the window
    pumps: List[Pump]
    answers: Dict[int, Answer]
    attempted: int
    unanswered: int           # requests never answered within the drain limit
    stray: int                # answers to no outstanding request
    tap_faults: int           # pumps after which the tap did not hold exactly one pass

    def in_window(self) -> List[int]:
        """The requests answered by the window's close."""
        return sorted(r for r, a in self.answers.items() if a.done <= self.close)


class Keeper:
    """The sampled requests' logits rows, copied as their passes return
    into a buffer made in set-up, so the window allocates nothing for them:
    a reservoir of ``sample`` rows, a uniform sample drawn from the seed of
    the requests the window answered, whatever their number."""

    def __init__(self, sched, vocab: int, device):
        import torch
        k = sched.sample
        self.buf = torch.empty((k, vocab), dtype=torch.float32, device=device)
        self.rid_at: List[Optional[int]] = [None] * k
        self.rng = np.random.default_rng([sched.seed, SAMPLE_STREAM])
        self.seen = 0
        self.offering = True        # off at the window's close

    def offer(self, rid: int, logits, row: int):
        if not self.offering:
            return
        slot = self.seen if self.seen < len(self.rid_at) else int(
            self.rng.integers(self.seen + 1))
        self.seen += 1
        if slot >= len(self.rid_at):
            return
        self.buf[slot].copy_(logits[row])
        self.rid_at[slot] = rid

    def sample(self) -> List[int]:
        """The reservoir's requests."""
        return sorted(r for r in self.rid_at if r is not None)

    def row(self, rid: int):
        """The kept logits of ``rid``, or None."""
        if rid not in self.rid_at:
            return None
        return self.buf[self.rid_at.index(rid)]


class Runner:
    def __init__(self, engine, tap: LogitsTap, tracer, keeper: Keeper):
        from repro_torch.serving.engine import Request
        self.Request = Request
        self.engine, self.tap, self.tracer, self.keeper = engine, tap, tracer, keeper
        self.pumps: List[Pump] = []
        self.answers: Dict[int, Answer] = {}
        self.outstanding: Dict[int, float] = {}     # rid -> its submission time
        self.stray = self.tap_faults = self.submitted = 0

    def submit(self, rid: int, tokens, sent: float):
        self.outstanding[rid] = sent
        self.submitted += 1
        self.engine.submit(self.Request(rid=rid, tokens=tokens, arrival_s=sent))

    def pump(self):
        ts = time.time()
        with self.tracer.span(PUMP):
            comps = self.engine.pump()
        te = time.time()
        fresh = self.tap.take()
        if len(fresh) != 1:
            self.tap_faults += 1
        idx = len(self.pumps)
        self.pumps.append(Pump(ts, te, len(comps), self.tracer.active))
        for row, c in enumerate(comps):
            if self.outstanding.pop(c.rid, None) is None:
                self.stray += 1
                continue
            self.answers[c.rid] = Answer(te, np.asarray(c.tokens), idx, row)
            if len(fresh) == 1:
                self.keeper.offer(c.rid, fresh[0], row)
        return comps

    def window(self, t0, close) -> Window:
        return Window(t0, close, self.pumps, self.answers,
                      self.submitted, len(self.outstanding), self.stray, self.tap_faults)


def run_closed(drv: Runner, sched, seconds: float, tracer) -> Window:
    t0 = time.time()
    rid = 0
    for _ in range(sched.clients):
        drv.submit(rid, sched.prompt(rid), t0)
        rid += 1
    while time.time() < t0 + seconds:
        tracer.poll(time.time() - t0)
        comps = drv.pump()
        if not comps:
            break
        end = drv.pumps[-1].end
        for _ in comps:                 # each answered caller sends its next request
            drv.submit(rid, sched.prompt(rid), end)
            rid += 1
    tracer.stop()
    drv.keeper.offering = False
    close = drv.pumps[-1].end if drv.pumps else time.time()
    deadline = close + DRAIN_LIMIT_S
    while drv.outstanding and time.time() < deadline:
        if not drv.pump():
            break
    return drv.window(t0, close)


def warm_up(engine, tap: LogitsTap, sched, pumps: int = 2):
    """Pumps of full batches of the cell's own prompt shape, before the
    window (every shape the window uses: the engine pads every pass to
    ``batch_size`` x ``prompt_len``)."""
    from repro_torch.serving.engine import Request
    for p in range(pumps):
        for r in range(engine.batch_size):
            engine.submit(Request(rid=-1 - r, tokens=sched.prompt(p * engine.batch_size + r),
                                  arrival_s=time.time()))
        engine.pump()
    tap.take()


def served_rows(win: Window, keeper: Keeper) -> Dict[int, Optional[tuple]]:
    """rid -> (its pass's logits row, its served first token) for each
    sampled request, or None where it was never answered or its row was
    not kept."""
    out = {}
    for rid in keeper.sample():
        a, row = win.answers.get(rid), keeper.row(rid)
        out[rid] = None if a is None or row is None else (row, int(a.token[0]))
    return out
