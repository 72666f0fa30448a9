"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` builds the program's configuration from the cell's
configuration file (and refuses one that differs from the sizes the file
states), draws the weights from the seed, builds the ``ServingEngine``
with them, warms it up, drives the window (``serve.py``), reads the
metrics through their readers (``metrics/<name>.py``), frees the
program's state and runs the check (``check.py``).  It returns the result
line's fields; ``run.py`` adds the device and prints it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import inspect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, serve, tracing
from .cell import Cell, family_module, metric_reader, peaks
from .traffic import make_schedule
from .weights import make_weights

TRACE_START_FRACTION = 0.75     # the profiler records from three quarters into the window
TRACE_SECONDS = 4.0             # for this long (or an eighth of the window)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    sz: Dict
    flops: object                 # flops/<family>.py
    peaks: Dict
    window: serve.Window
    seconds: float
    setup_s: float
    trace: Optional[Dict]         # tracing.summarize's result, in a traced run
    traced_from: Optional[float] = None   # time.time() when the profiler began to record

    @property
    def seq(self) -> int:
        return int(self.cell.traffic["prompt_len"])

    def window_pumps(self) -> List[serve.Pump]:
        """Pumps that served the window: those that ended by its close (not
        the drain)."""
        w = self.window
        return [p for p in w.pumps if p.end <= w.close]

    def host_end(self) -> float:
        """Where the host-clock metrics stop reading: the window's close,
        or in a traced run the start of recording."""
        return self.traced_from if self.traced_from is not None else self.window.close

    def host_pumps(self) -> List[serve.Pump]:
        """The window's pumps that the host-clock metrics read: in a traced
        run those that ended before recording began."""
        if self.traced_from is None:
            return self.window_pumps()
        return [p for p in self.window_pumps() if p.end <= self.traced_from]

    def counts(self, rows: int, group: str):
        return self.flops.pass_counts(self.sz, rows, self.seq)[group]


def program_config(cell: Cell):
    """The program's ArchConfig for the cell, checked against the sizes the
    configuration file states, and the sizes the reference reads."""
    from repro_torch.configs import get_config
    c = cell.config
    cfg = get_config(c["arch"]).replace(**c.get("overrides", {}))
    for key, want in c["sizes"].items():
        got = cfg.hd if key == "head_dim" else getattr(cfg, key)
        if got != want:
            raise ValueError(f"{cell.config_name}: the program's {key} is {got}, the file's {want}")
    sz = dict(c["sizes"])
    for key, spec in c.get("constants", {}).items():
        got = _program_value(spec["program"])
        if got != spec["value"]:
            raise ValueError(f"{cell.config_name}: the program's {spec['program']} is {got}, "
                             f"the file's {key} {spec['value']}")
        sz[key] = spec["value"]
    return cfg, sz


def _program_value(where: str):
    """``module.ATTR`` or ``module.function:argument`` (its default)."""
    path, _, arg = where.partition(":")
    mod, _, name = path.rpartition(".")
    obj = getattr(importlib.import_module(mod), name)
    return inspect.signature(obj).parameters[arg].default if arg else obj


def build_engine(cell: Cell, cfg, params, device):
    from repro_torch.serving.engine import ServingEngine
    tr = cell.traffic
    return ServingEngine(cfg, batch_size=int(tr["batch_size"]), prompt_len=int(tr["prompt_len"]),
                         decode_tokens=int(tr["decode_tokens"]), params=params, device=device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=lambda msg: None) -> Dict:
    """``t_start``: the process's start on the ``time.time()`` clock."""
    from repro_torch.kernels import ops
    log("set-up: the program's kernel wrappers imported")
    cuda = torch.device(device).type == "cuda"
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cfg, sz = program_config(cell)
    from repro_torch.models.zoo import build_model
    log("set-up: the program's models imported")
    abstract = build_model(cfg, "cpu").abstract_params(torch.float32)
    log("set-up: the parameter tree's shapes read")
    params = make_weights(abstract, cell.config["init"], seed, device)
    sched = make_schedule(cell.traffic, seed, cfg.vocab_size)
    if cuda:
        torch.cuda.synchronize()
    log("set-up: weights drawn")
    engine = build_engine(cell, cfg, params, device)
    log("set-up: engine built and its first pass made (the kernels' library loaded)")
    tap = serve.LogitsTap(engine.model)
    engine.model = tap
    serve.warm_up(engine, tap, sched)
    if cuda:
        torch.cuda.synchronize()
    log("set-up: warm-up pumps made")
    tracer = (tracing.Tracer(TRACE_START_FRACTION * seconds,
                             min(TRACE_SECONDS, seconds / 8), "cuda" if cuda else "cpu")
              if trace else tracing.NoTracer())
    drv = serve.Runner(engine, tap, tracer, serve.Keeper(sched, cfg.vocab_size, device))
    ops.reset_launch_counts()
    gc.collect()
    gc.freeze()       # set-up's objects out of the collector's way: its passes stay short
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    win = serve.run_closed(drv, sched, seconds, tracer)
    gc.unfreeze()
    walls = np.array([p.end - p.start for p in win.pumps]) * 1e3
    log(f"pumps: {len(walls)}, wall ms p50 {np.percentile(walls, 50):.2f} "
        f"p99 {np.percentile(walls, 99):.2f} max {walls.max():.2f}")
    launches = ops.launch_counts()
    summary = None
    if trace:
        t = time.perf_counter()
        summary = tracing.summarize(tracer, [p.rows for p in win.pumps if p.traced])
        log(f"trace read in {time.perf_counter() - t:.1f} s: "
            f"{summary and summary['device_ops']} device operations")
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell, sz, family_module("flops", cell.config["family"]), peaks(), win,
              float(seconds), setup_s, summary, tracer.started)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the check: the program's state freed, the weights drawn again
    served = serve.served_rows(win, drv.keeper)
    del engine, tap, drv, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    params = make_weights(abstract, cell.config["init"], seed, device)
    ref = check.reference_module(cell.config["family"])
    numbers = check.compare(served, sched.prompt, ref, params, sz, device,
                            win.unanswered + win.stray)
    numbers["tap_faults"] = float(win.tap_faults)
    checks = check.judge(numbers, cell.config["limits"])
    log(f"check of {len(served)} requests in {time.perf_counter() - t:.1f} s")
    del params
    out = {"correct": check.passed(checks), "attempted": int(win.attempted),
           "failed": int(win.unanswered), "metrics": metrics,
           "memory_peak_bytes": int(mem_peak), "launches": launches,
           "pumps": len(win.pumps), "sample": sorted(served), "checks": checks}
    if summary is not None:
        out["trace"] = summary
    return out
