"""The harness end to end on the CPU: a cut configuration through
``ServingEngine(device="cpu")``, the window, the metrics, the check and the
result line."""
import io
import json
import time

import pytest

from conftest import CELLS, small_cell
from harness import report
from harness.bench import run_cell

SEED = 2**31 + 987654321          # past 32 signed bits: seeds may be that large


@pytest.mark.parametrize("name", CELLS)
def test_run_prints_a_well_formed_line(name):
    cell = small_cell(name)
    res = run_cell(cell, SEED, 1.5, False, "cpu", time.time())
    out = report.line(res, "cpu (test)", 1, False, "no card")
    stdout, stderr = io.StringIO(), io.StringIO()
    report.emit(out, stdout, stderr)
    last = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    want = {m["name"] for m in cell.end_to_end}
    assert set(last["metrics"]) == want
    assert all(m["value"] > 0 for m in last["metrics"].values())
    err = stderr.getvalue().strip().splitlines()
    assert [ln.split(":")[0] for ln in err] == [f"check {k}" for k in last["checks"]]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_host_metrics_and_refuses_no_device_time(name):
    cell = small_cell(name)
    res = run_cell(cell, SEED + 1, 2.0, True, "cpu", time.time())
    assert res["correct"]
    assert res["trace"]["pumps"], "the tracer marked no pump"
    host = {"pass_ms.w5", "pass_ms.w6", "mfu.w5", "mfu.w6"}
    assert set(res["metrics"]) == host & {m["name"] for m in cell.per_layer}
    with pytest.raises(report.NoDeviceTime):
        report.line(res, "cpu (test)", 1, True, "no card")
