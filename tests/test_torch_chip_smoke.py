"""``chip_smoke.py`` reads the benchmark's cells from the benchmark's own
files, on the CPU and with no engine built: it checks every workload of
``BENCHMARK.json`` and no other, and the kernel shapes it derives from a
cell's configuration and traffic are the ones its prefill runs.

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke(monkeypatch):
    """The script as a module; the path to ``perfbench/`` that reading the
    cells adds is taken away after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_checks_every_benchmark_cell_and_no_other(chip_smoke):
    """The cell passes run over BENCHMARK.json's workloads, and the expected
    products a pass (GEMM_CELL_PASS) have one entry for each and no other:
    a cell added to the benchmark without its counts fails here."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    workloads = [w["name"] for w in manifest["workloads"]]
    cells = chip_smoke.benchmark_cells()
    assert list(cells) == workloads
    assert sorted(chip_smoke.GEMM_CELL_PASS) == sorted(workloads)
    for name, (cell, cfg) in cells.items():
        assert cell.name == name and cfg.name == cell.config["arch"]


def test_kernel_shapes_follow_the_cells_configuration(chip_smoke):
    """granite's cell (24 prompts of 64 tokens, 18 of 72 experts held,
    top-10, Mamba2 of 128 heads of 64 at state 128) gives the scan and the
    grouped products their served shapes, deepseek-v2-lite's (6 prompts of
    64, all 64 experts, top-6) the grouped products'; the other cells have
    neither."""
    shapes = {name: chip_smoke.kernel_shapes(*cc)
              for name, cc in chip_smoke.benchmark_cells().items()}
    assert shapes == {
        "qwen15-4b.w6-closed": {},
        "rwkv6-1.6b.w5-closed": {},
        "granite4-h-small.w6x4-closed": {"ssd_scan": (24, 64, 128, 64, 128),
                                         "moe_experts": (1536, 4096, 768, 72, 18, 10)},
        "deepseek-v2-lite.w6-closed": {"moe_experts": (384, 2048, 1408, 64, 64, 6)}}
