"""A later cell, traffic mix and metrics are new files and new entries: in a
copy of the benchmark, a closed-loop mix for qwen1.5-4b, its end-to-end
metric and a per-layer metric are added beside the files that are there,
none of which changes, and the copy's harness runs the new cell and reads
the new metrics."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import ROOT, SMALL

RUN = """
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/perfbench", sys.argv[2]]
from harness.cell import load_cell
from harness.bench import run_cell
cell = load_cell("qwen15-4b.w2-closed", manifest=__import__("pathlib").Path(sys.argv[1]) / "BENCHMARK.json")
small = json.loads(sys.argv[3])
cell.config["sizes"].update(small)
cell.config["overrides"] = dict(cell.config["overrides"], **small)
cell.traffic["prompt_len"] = 16
res = run_cell(cell, 41, 2.0, True, "cpu", time.time())
print(json.dumps({"correct": res["correct"], "metrics": sorted(res["metrics"]),
                  "answered": res["metrics"]["answered.w2"]["value"]}))
"""


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "perfbench")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())

    (tmp_path / "perfbench" / "traffic" / "w2-closed.json").write_text(json.dumps(
        {"loop": "closed", "clients": 6, "batch_size": 3, "prompt_len": 64,
         "decode_tokens": 1, "sample": 64}))
    metrics = tmp_path / "perfbench" / "metrics"
    (metrics / "answered.w2.py").write_text(
        '"""answered.w2: requests answered in the window (host counter)."""\n\n\n'
        "def read(run):\n    return len(run.window.in_window())\n")
    (metrics / "throughput_rps.w2.py").write_text(
        (metrics / "throughput_rps.w6.py").read_text().replace("throughput_rps.w6",
                                                              "throughput_rps.w2"))
    manifest["workloads"].append({"name": "qwen15-4b.w2-closed", "config": "qwen15-4b-f32",
                                  "traffic": "w2-closed", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "answered.w2", "unit": "req", "better": "higher",
                                  "source": "program_counter", "layer": "engine",
                                  "moves": "throughput_rps.w2",
                                  "workloads": ["qwen15-4b.w2-closed"]})
    manifest["end_to_end"].append({"name": "throughput_rps.w2", "unit": "req/s",
                                   "better": "higher", "bound": 0.16, "source": "host_clock",
                                   "workloads": ["qwen15-4b.w2-closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), str(ROOT / "src"),
                          json.dumps(SMALL["dense"])],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "answered.w2" in got["metrics"] and got["answered"] > 0
    after = _digests(tmp_path / "perfbench")
    assert {k: after[k] for k in before} == before
