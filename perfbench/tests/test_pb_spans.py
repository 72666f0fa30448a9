"""The readers of the program's per-pass log (``harness/passlog.py`` and
``metrics/{dispatch,fetch_wait,engine}_ms.*``): on synthetic records, the
window's host pumps alone, the traced pumps left out, None for a log that
lost a pass, a CPU engine's records or a program without the log; on a CPU
engine through the window, one record for each pump that ``pass_ms``
reads."""
import sys

import pytest
import torch

from conftest import CELLS, small_cell
from harness import serve, tracing
from harness.bench import Run, build_engine, program_config
from harness.cell import metric_reader
from harness.passlog import phase_ms, window_passes
from harness.traffic import make_schedule
from harness.weights import make_weights
from repro_torch.profiling import spans
from repro_torch.serving.telemetry import RingBuffer

T0 = 1_700_000_000.0            # the window's start, seconds on the time.time() clock
NS = 1_000_000_000


def _record(start_s, phases_ms, device="cuda"):
    stamps = [int(start_s * NS)]
    for ms in phases_ms:
        stamps.append(stamps[-1] + int(ms * 1e6))
    return spans.PassRecord(engine=0, device=device, rows=6, batch_size=6, queued=24,
                            oldest_arrival_s=start_s - 0.1, stamps_ns=tuple(stamps))


def _run(log, close_s, traced_from=None):
    """A run whose window served the log's passes that started in it."""
    pumps = [serve.Pump(r.start_ns / NS, r.end_ns / NS, r.rows,
                        traced_from is not None and r.start_ns / NS >= traced_from)
             for r in log if r.start_ns >= T0 * NS]
    win = serve.Window(T0, T0 + close_s, pumps, {}, 0, 0, 0, 0)
    return Run(None, {}, None, {}, win, close_s, 0.0, None, traced_from)


@pytest.fixture
def log(monkeypatch):
    ring = RingBuffer(64)
    monkeypatch.setattr(spans, "_PASSES", ring)
    return ring


def test_only_the_windows_pumps_are_read(log):
    log.append(_record(T0 - 0.5, (1, 90, 2, 1)))          # warm-up, before the window
    log.append(_record(T0 + 0.1, (0.2, 80, 4, 0.3)))
    log.append(_record(T0 + 0.2, (0.4, 84, 6, 0.1)))
    log.append(_record(T0 + 9.95, (0.2, 80, 4, 0.3)))     # ends past the close: the drain
    run = _run(log, 10.0)
    assert len(window_passes(run)) == 2
    assert phase_ms(run, "engine.dispatch") == pytest.approx(82.0)
    assert phase_ms(run, "engine.fetch") == pytest.approx(5.0)
    assert phase_ms(run, "engine.take", "engine.complete") == pytest.approx(0.5)


def test_a_traced_runs_recorded_pumps_are_left_out(log):
    for k in range(8):
        log.append(_record(T0 + 0.1 * k, (0.2, 80, 4, 0.3)))
    for k in range(3):                                      # recorded: the profiler slows them
        log.append(_record(T0 + 1.0 + 0.2 * k, (0.2, 150, 4, 0.3)))
    run = _run(log, 2.0, traced_from=T0 + 0.95)
    assert len(window_passes(run)) == 8
    assert phase_ms(run, "engine.dispatch") == pytest.approx(80.0)


@pytest.mark.parametrize("w", ["w5", "w6"])
def test_the_readers_split_the_pass(log, w):
    for k in range(4):
        log.append(_record(T0 + 0.1 * k, (0.2, 60 + k, 10 - k, 0.3)))
    run = _run(log, 1.0)
    read = {m: metric_reader(f"{m}.{w}").read(run)
            for m in ("dispatch_ms", "fetch_wait_ms", "engine_ms")}
    assert read == pytest.approx({"dispatch_ms": 61.5, "fetch_wait_ms": 8.5,
                                  "engine_ms": 0.5})
    whole = sum(r.end_ns - r.start_ns for r in window_passes(run)) / 4 / 1e6
    assert sum(read.values()) == pytest.approx(whole)


def test_a_log_that_lost_a_pass_reads_none(log, monkeypatch):
    """Fewer records than pumps (the ring overflowed, or a pass went
    unrecorded) would average a subset: the readers read nothing."""
    for k in range(4):
        log.append(_record(T0 + 0.1 * k, (0.2, 80, 4, 0.3)))
    run = _run(log, 1.0)
    assert phase_ms(run, "engine.dispatch") == pytest.approx(80.0)
    small = RingBuffer(3)
    for r in log:
        small.append(r)
    monkeypatch.setattr(spans, "_PASSES", small)
    assert small.dropped == 1 and len(window_passes(run)) == 3
    assert phase_ms(run, "engine.dispatch") is None
    assert metric_reader("fetch_wait_ms.w5").read(run) is None


def test_a_cpu_engine_or_a_program_without_the_log_reads_none(log, monkeypatch):
    log.append(_record(T0 + 0.1, (0.2, 80, 4, 0.3), device="cpu"))
    run = _run(log, 1.0)
    assert phase_ms(run, "engine.dispatch") is None
    assert phase_ms(_run(log, 0.01), "engine.dispatch") is None    # no pass in the window
    import repro_torch.profiling
    monkeypatch.delattr(repro_torch.profiling, "spans")         # the parent's program
    monkeypatch.setitem(sys.modules, "repro_torch.profiling.spans", None)
    assert window_passes(run) is None
    assert metric_reader("dispatch_ms.w6").read(run) is None


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_one_record_for_each_pump_pass_ms_reads(name, traced):
    """A CPU engine through the harness's window, traced or not: the log's
    records in the window are the pumps ``Run.host_pumps`` keeps."""
    cell = small_cell(name)
    cfg, sz = program_config(cell)
    from repro_torch.models.zoo import build_model
    abstract = build_model(cfg, "cpu").abstract_params(torch.float32)
    params = make_weights(abstract, cell.config["init"], 7, "cpu")
    sched = make_schedule(cell.traffic, 7, cfg.vocab_size)
    engine = build_engine(cell, cfg, params, "cpu")
    tap = serve.LogitsTap(engine.model)
    engine.model = tap
    serve.warm_up(engine, tap, sched)
    seconds = 1.2
    tracer = tracing.Tracer(0.5 * seconds, 0.3, "cpu") if traced else tracing.NoTracer()
    drv = serve.Runner(engine, tap, tracer, serve.Keeper(sched, cfg.vocab_size, "cpu"))
    win = serve.run_closed(drv, sched, seconds, tracer)
    run = Run(cell, sz, None, {}, win, seconds, 0.0, None, tracer.started)
    recs = window_passes(run)
    assert len(recs) == len(run.host_pumps()) > 0
    assert [r.rows for r in recs] == [p.rows for p in run.host_pumps()]
    assert all(r.engine == engine.engine_id for r in recs)
    assert phase_ms(run, "engine.dispatch") is None                 # a CPU engine's
    if traced:
        assert len(run.host_pumps()) < len(run.window_pumps())
