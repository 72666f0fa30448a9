"""The planner's data and configuration in the port: the fitted profiles
(``repro_torch.core.experiments.fitted_context``, fitted on the port's own
simulated testbed), the served-model table and
workload sets, ``PlannerConfig``'s validation, and the torch backend's
device rule (cuda:0 by default, raising without CUDA, never the CPU
unless asked for)."""
import dataclasses

import pytest

from repro.core import types as rtypes
from repro.core.experiments import fitted_context as ref_fitted_context
from repro.serving import workload as rworkload
from tests._torch_planner import port, torch
from tests.test_perf_model_vec import _profiles

from repro_torch.core import provisioner as prov
from repro_torch.core import types
from repro_torch.core.experiments import fitted_context
from repro_torch.core.types import V5E, PlannerConfig, WorkloadSpec, planner_config
from repro_torch.kernels import grant_loop
from repro_torch.serving import workload


@pytest.mark.parametrize("hw_name", ["tpu-v5e", "tpu-v4"])
def test_fitted_context_equals_reference(hw_name):
    ref, got = ref_fitted_context(hw_name), fitted_context(hw_name)
    assert dataclasses.asdict(got.hw) == dataclasses.asdict(ref.hw)
    assert got.hw == port(ref.hw)
    assert list(got.profiles) == list(ref.profiles)
    for name, c in ref.profiles.items():
        assert dataclasses.asdict(got.profiles[name]) == dataclasses.asdict(c), name
    assert (port(rtypes.V5E), port(rtypes.V4)) == (types.V5E, types.V4)


def test_served_models_and_workloads_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in workload.models().items()} == \
        {k: dataclasses.asdict(v) for k, v in rworkload.models().items()}
    assert workload.APP_TABLE == rworkload.APP_TABLE
    for fn, args in (("twelve_workloads", ()), ("three_workloads", ()),
                     ("synthetic_workloads", (1000, 0))):
        assert getattr(workload, fn)(*args) == port(getattr(rworkload, fn)(*args)), fn


def test_planner_config_validation_mirrors_reference():
    """The reference's knobs and checks (tests/test_planner_config.py), with
    backend "torch" in place of "jax"; the default runs on the card."""
    cfg = PlannerConfig()
    assert (cfg.backend, cfg.device, cfg.engine, cfg.budget, cfg.batch,
            cfg.replicate, cfg.k_max) == \
        ("torch", None, "vec", "queueing", "eq17", False, prov.K_MAX)
    for bad in (dict(backend="tensorflow"), dict(engine="gpu"), dict(batch="auto"),
                dict(budget="thirds"), dict(k_max=0)):
        for cls in (PlannerConfig, rtypes.PlannerConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    with pytest.raises(ValueError):               # the reference's jax + scalar
        rtypes.PlannerConfig(backend="jax", engine="scalar")
    # the port's: the torch backend needs the vectorized engine (so the
    # scalar oracle names backend="numpy"), and a device names the torch
    # backend; the reference's "jax" is no backend of the port
    for bad in (dict(backend="torch", engine="scalar"), dict(engine="scalar"),
                dict(backend="numpy", device="cpu"), dict(backend="jax")):
        with pytest.raises(ValueError):
            PlannerConfig(**bad)
    assert PlannerConfig(backend="numpy", engine="scalar").engine == "scalar"
    with pytest.raises(TypeError, match="not both"):
        planner_config(PlannerConfig(), budget="half")
    base = PlannerConfig(batch="joint", k_max=3, device="cpu")
    got = planner_config(None, base=base, budget="half")
    assert (got.batch, got.k_max, got.budget, got.device) == ("joint", 3, "half", "cpu")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.device = "cpu"
    assert cfg.replace(device="cpu") == PlannerConfig(device="cpu")
    assert hash(cfg) == hash(PlannerConfig())


def test_default_config_needs_cuda_and_never_runs_on_cpu(monkeypatch):
    """PlannerConfig() asks for cuda:0: without CUDA a plan raises from
    resolve_device, before any grant loop runs on the CPU; the CPU runs
    only when asked for by name."""
    def no_plain(*a, **k):
        raise AssertionError("the grant loop ran on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(grant_loop, "alloc_all_plain", no_plain)
    specs = [WorkloadSpec("W0", "mid", 150.0, 40.0)]
    profiles = port(_profiles())
    for call in (lambda: prov.provision(specs, profiles, V5E),
                 lambda: prov.provision(specs, profiles, V5E, budget="half"),
                 lambda: prov.add_workload(prov.ProvisioningPlan(hardware=V5E),
                                           specs[0], profiles, V5E)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(AssertionError, match="ran on the CPU"):
        prov.provision(specs, profiles, V5E, config=PlannerConfig(device="cpu"))
    plan = prov.provision(specs, profiles, V5E, config=PlannerConfig(backend="numpy"))
    assert plan.n_gpus == 1
