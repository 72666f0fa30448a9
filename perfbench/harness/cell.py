"""Find a cell's parts by name.

``BENCHMARK.json`` names every configuration, traffic mix and metric; each
lives in a file of its own under ``perfbench/``, found by that name:

- ``configs/<config>.json``: the configuration's sizes, its weights' draw,
  the limits of its correctness check and its family, which names
  ``reference/<family>.py`` and ``flops/<family>.py``;
- ``traffic/<traffic>.json``: the parameters the one generator reads;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

So a later cell, mix or metric is a new file and a new entry, and no file
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict           # configs/<config>.json
    traffic_name: str
    traffic: Dict          # traffic/<traffic>.json
    end_to_end: List[Dict]     # the manifest's metrics this cell reports
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Path = MANIFEST) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic
    and metric entries read from their files."""
    m = load_json(manifest)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    cfg_entry = configs[w["config"]]
    base = manifest.parent
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(base / cfg_entry["file"]),
                traffic_name=w["traffic"],
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[e for e in m["end_to_end"] if _reports(e, name)],
                per_layer=[e for e in m["per_layer"] if _reports(e, name)])


def load_module(path: Path, name: str):
    """Import a file by its path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def family_module(kind: str, family: str):
    """``reference/<family>.py`` or ``flops/<family>.py``."""
    return load_module(BENCH_DIR / kind / f"{family}.py", f"perfbench_{kind}_{family}")


def peaks() -> Dict:
    return load_json(BENCH_DIR / "peaks.json")
