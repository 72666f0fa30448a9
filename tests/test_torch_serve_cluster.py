"""The port's launcher in cluster mode against the JAX package's: the same
plan (devices, cost) and the same ok / VIOLATION flag for every workload of
the paper's 12-workload study, with the port's planner and simulator on
their torch backend asked for on the CPU; and no CPU fallback."""
import re

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro.launch import serve as ref_serve  # noqa: E402

from repro_torch.launch import serve  # noqa: E402


def summary(out):
    """(devices, cost line, {workload: flag}) from cluster()'s output."""
    head = re.search(r"^devices=(\d+) cost=(\S+) arrivals=(\w+)$", out, re.M)
    flags = dict(re.findall(r"^  (W\d+)\s.* (ok|VIOLATION)$", out, re.M))
    return int(head.group(1)), head.group(2), head.group(3), flags


@pytest.mark.parametrize("strategy,poisson", [("iGniter", False), ("gpu-lets+", True)])
def test_cluster_matches_reference(capsys, strategy, poisson):
    ref_serve.cluster(strategy, 4.0, poisson)
    want = capsys.readouterr().out
    serve.cluster(strategy, 4.0, poisson, device="cpu")
    got = capsys.readouterr().out
    assert summary(got) == summary(want)
    assert len(summary(got)[3]) == 12


def test_cluster_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.cluster("iGniter", 1.0, False)
