"""Shared set-up of the planner's parity tests (tests/test_torch_planner_*.py
and tests/test_torch_provisioner.py).

They hold the port's planner (``repro_torch.core``) against the JAX
package's numpy oracle at the reference's own JAX contract (floats to
rtol=1e-6, atol=1e-9; decisions and grid points identical) and draw their
inputs with the reference's helpers in ``tests/test_perf_model_vec.py``.
They import neither ``repro.core.perf_model_jax`` nor
``repro.serving.physics_jax``: either switches JAX to 64-bit for the whole
worker process.  The files keep to four tests each, as
``tests/_torch_parity.py`` explains.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.core import coefficients, perf_model as pm  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.core.types import PlannerConfig  # noqa: E402
from repro_torch.profiling import metrics  # noqa: E402
from repro_torch.serving import faults, physics, simulator, traces  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-9)
# the torch backend's plain version, asked for by name; and the oracle
BACKENDS = {"torch-cpu": PlannerConfig(backend="torch", device="cpu"),
            "numpy": PlannerConfig(backend="numpy")}


# the port's modules that hold the reference's dataclasses, by name
PORT_TYPES = (T, pm, coefficients, metrics, physics, traces, faults, simulator)


def port(obj):
    """A reference dataclass instance (or a list or dict of them) as the
    port's type of the same name, field for field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(port(o) for o in obj)
    if isinstance(obj, dict):
        return {k: port(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = [getattr(m, name) for m in PORT_TYPES if hasattr(m, name)][0]
        return cls(**{f.name: port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj
