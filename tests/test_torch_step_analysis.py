"""The port's step analysis (``profiling/step_analysis.py``) against the JAX
package's HLO analyzer: flops of plain products, the collectives' ring
bytes over a fake process group, and a whole reduced train step."""
import jax
import numpy as np
import pytest

from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.profiling import hlo_analysis as H
from tests._torch_parity import jax_32bit, models, torch  # noqa: F401
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps
from repro_torch.launch.shapes import InputShape
from repro_torch.profiling.step_analysis import StepAnalysis, roofline

pytestmark = pytest.mark.jax              # the JAX package is the reference


def test_products_count_their_flops():
    """A loop of 10 products of 256^3 counts 10 * 2 * 256^3, as the
    reference's trip-count-aware analyzer does; the bytes are each
    product's two inputs and output."""
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with StepAnalysis() as s:
        x = a
        for _ in range(10):
            x = x @ b
    assert s.flops == 10 * 2 * 256 ** 3
    assert s.hbm_bytes == 10 * 3 * 256 * 256 * 4
    assert s.collective_bytes == 0 and s.peak_bytes >= 256 * 256 * 4
    r = roofline(s)
    assert r.dominant == "memory" and r.compute_s == s.flops / 989e12


def test_collective_ring_bytes_over_a_fake_group():
    """Over a fake process group of 64 ranks: an all-gather in groups of 4
    counts 0.75 * n, an all-reduce in groups of 8 counts 2 * 7/8 * n (the
    reference's numbers, tests/test_sharding.py)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=64)
    try:
        m4 = init_device_mesh("cpu", (16, 4), mesh_dim_names=("a", "b"))
        m8 = init_device_mesh("cpu", (8, 8), mesh_dim_names=("a", "b"))
        x = torch.zeros((64, 64))
        n = x.numel() * 4
        with StepAnalysis() as s:
            g = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, m4.get_group("b")))
            r = funcol.wait_tensor(funcol.all_reduce(g[:64], "sum", m8.get_group("b")))
        assert g.shape == (256, 64) and r.shape == (64, 64)
        # all-gather: (g-1)/g of its output (4n); all-reduce: 2(g-1)/g of its input
        assert s.per_collective["all-gather"] == pytest.approx(0.75 * 4 * n)
        assert s.per_collective["all-reduce"] == pytest.approx(2 * 7 / 8 * n)
        assert s.collective_bytes == pytest.approx(0.75 * 4 * n + 2 * 7 / 8 * n)
    finally:
        dist.destroy_process_group()


def test_train_step_flops_match_the_hlo_analysis(monkeypatch, capsys):
    """The reduced qwen3-4b train step (remat on, one device): the port's
    count of the step the builder makes is within 5 % of the reference's
    ``hlo_analysis.analyze`` of its jitted step on the same config."""
    B, S = 2, 32
    jcfg, _, _, cfg, _, params = models("qwen3-4b")
    shape = InputShape("reduced", S, B, "train")
    # the reference's builder: the reduced config in place of the shape's
    monkeypatch.setattr(jsteps, "effective_config", lambda arch, name: jcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jshape = jshapes.InputShape("reduced", S, B, "train")
    jst = jsteps.make_train_step("qwen3-4b", mesh, shape=jshape, remat=True)
    with mesh:
        compiled = jst.fn.lower(*jst.abstract_args).compile()
    want = H.analyze(compiled.as_text()).flops

    st = steps.make_train_step("qwen3-4b", {"data": 1, "model": 1}, shape=shape, cfg=cfg,
                               remat=True)
    batch = {k: torch.from_numpy(v) for k, v in next(make_pipeline(cfg, B, S, seed=0)).items()}
    opt_state = steps.AdamW().init(params)
    with StepAnalysis() as s:
        _, _, loss = st.fn(params, opt_state, batch)
    assert np.isfinite(float(loss))
    with capsys.disabled():
        print(f"\nreduced qwen3-4b train step flops: port {s.flops:.6g}, reference {want:.6g}")
    assert abs(s.flops / want - 1) <= 0.05, (s.flops, want)
