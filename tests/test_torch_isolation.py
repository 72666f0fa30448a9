"""The port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch/`` or ``chip_smoke.py``, and no silent CPU fallback."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.device import resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def _reaches_jax_or_repro(tree):
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _foreign(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id in ("jax", "jnp"):
                bad.append(f"{node.value.id}.{node.attr}")
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in ("__import__", "import_module") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and _foreign(str(arg.value)):
                    bad.append(str(arg.value))
    return bad


def test_port_imports_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = {p.relative_to(PORT).as_posix() for p in files if PORT in p.parents}
    for mod in ("device.py", "configs/base.py", "kernels/ops.py",
                "kernels/rwkv6_scan.py", "kernels/ssd_scan.py",
                "models/attention.py", "models/rwkv.py", "models/ssm.py", "models/moe.py",
                "serving/engine.py", "launch/serve.py", "core/types.py",
                "core/queueing.py", "core/perf_model.py", "core/replication.py",
                "core/perf_model_vec.py", "core/perf_model_torch.py",
                "core/provisioner.py", "core/experiments.py", "core/baselines.py",
                "core/coefficients.py", "kernels/grant_loop.py", "kernels/tables.py",
                "profiling/metrics.py", "serving/workload.py", "serving/traces.py",
                "serving/faults.py", "serving/physics.py", "serving/physics_torch.py",
                "serving/telemetry.py", "serving/simulator.py",
                "serving/controller.py"):
        assert mod in found
    bad = {str(p.relative_to(REPO)): _reaches_jax_or_repro(ast.parse(p.read_text()))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_resolve_device_cpu_on_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_defaults_to_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
