"""The grouped expert kernel's token-tile edges, its tile counter and its
names in the benchmark's trace, on the CPU.

``chip_smoke.MOE_EDGES`` are the cases at the edges of the kernel's token
tile (``moe_gemm.TILE_ROWS`` rows) that ``chip_smoke.check_moe`` holds the
kernel to on a card; ``moe.held_counts()["tiles"]`` counts the tiles the
kernel runs, each a stream of its expert's weights; every
``moe_gemm_kernel`` instantiation of ``csrc/moe.cu`` is what
``perfbench/metrics/moe_roofline.w6.py`` reads and what the trace groups
with the products.  The kernel itself runs only on a card
(``chip_smoke.check_moe``, ``tests/test_torch_granite_kernels.py``).

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_granite import small_model
from repro_torch.kernels import moe_gemm, ops
from repro_torch.models import moe

REPO = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", range(6))
def test_tile_edges_are_the_edges_they_name(case, monkeypatch):
    """Each of chip_smoke's six tile-edge cases holds an expert of whole
    tiles, one of a tile and a row, an empty one and unheld experts; its
    inputs route each held expert exactly its rows, a token's assignments to
    distinct experts, and the layer's plain version on them equals a sum
    over each token's held assignments in float64."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    chip_smoke = _module("chip_smoke", REPO / "chip_smoke.py")
    assert len(chip_smoke.MOE_EDGES) == 6
    T, K, E, held, rows = chip_smoke.MOE_EDGES[case]
    w = moe_gemm.TILE_ROWS
    assert len(rows) == held < E and 0 in rows and sum(rows) <= T * K and max(rows) <= T
    assert {0, 1} <= {r % w for r in rows if r} and max(rows) > w
    x, tok, offsets, gates, pos, wg, wu, wd = chip_smoke.moe_edge_inputs(
        np.random.default_rng(case), T, K, E, held, rows, 16, 8, torch.device("cpu"))
    assert np.diff(offsets.numpy()).tolist() == list(rows)
    assert torch.equal(tok[pos], torch.arange(T)[:, None].expand(T, K))
    sorted_expert = torch.searchsorted(offsets, torch.arange(T * K), right=True) - 1
    for t in range(T):
        held_rows = [int(r) for r in pos[t] if r < offsets[-1]]
        assert len({int(sorted_expert[r]) for r in held_rows}) == len(held_rows)
    y = ops.moe_experts(x, tok, offsets, gates, pos, wg, wu, wd)
    xd, want = x.double(), torch.zeros(T, x.shape[1], dtype=torch.float64)
    for r in range(int(offsets[-1])):
        e, t = int(sorted_expert[r]), int(tok[r])
        h = torch.nn.functional.silu(xd[t] @ wg[e].double()) * (xd[t] @ wu[e].double())
        want[t] += float(gates[r]) * (h @ wd[e].double())
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("held, B, S, one_expert", [
    (8, 2, 32, True),      # expert 1 takes all 64 tokens, two tiles
    (3, 2, 9, False),      # 3 of 8 held
    (8, 1, 20, False),     # 20 tokens
])
def test_tiles_count_the_kernels_token_tiles(held, B, S, one_expert):
    """held_counts' tiles after apply_moe_dropless equal sum over held
    experts of ceil(rows / TILE_ROWS), recounted from route_sorted's
    offsets; experts counts the held experts with rows."""
    model, params = small_model(seed=5, experts_held=held)
    cfg = model.cfg
    p = dict(params["blocks"][0]["moe"])
    x = torch.rand(B, S, cfg.d_model, generator=torch.Generator().manual_seed(held + S)) - 0.5
    if one_expert:
        p["router"] = p["router"].clone()
        p["router"][:, 1] = 1.0
        x = x.abs()
    T = B * S
    _, _, offsets, _ = moe.route_sorted(p["router"], x.reshape(T, -1), cfg.top_k, cfg.n_held,
                                        cfg.norm_topk)
    rows = np.diff(offsets.numpy())
    moe.reset_held_counts()
    with torch.inference_mode():
        moe.apply_moe_dropless(p, x, cfg, layer=2)
    got = moe.held_counts()[2]
    assert got["tiles"] == int(np.sum(-(-rows // moe_gemm.TILE_ROWS)))
    assert got["experts"] == int(np.count_nonzero(rows))
    if one_expert:
        assert rows[1] == T and got["tiles"] > got["experts"]


def test_every_instantiation_is_read_by_the_benchmark(monkeypatch):
    """csrc/moe.cu's token tile is moe_gemm.TILE_ROWS, and its two
    instantiations (gate and up, down) carry names that moe_roofline.w6's
    KERNEL matches and the trace groups as ``matmul``; chip_smoke's SASS
    check expects that many."""
    src = (Path(moe_gemm.__file__).parent / "csrc" / "moe.cu").read_text()
    assert re.findall(r"constexpr int MG_BT = (\d+);", src) == [str(moe_gemm.TILE_ROWS)]
    assert "template <bool GATED>\n__global__ void __launch_bounds__(MG_THREADS, 1)\n" \
           "    moe_gemm_kernel(const __grid_constant__ CUtensorMap tm0," in src
    monkeypatch.setattr(sys, "path", [str(REPO / "perfbench"), *sys.path])
    from harness import tracing
    metric = _module("moe_roofline_w6", REPO / "perfbench" / "metrics" / "moe_roofline.w6.py")
    chip_smoke = _module("chip_smoke", REPO / "chip_smoke.py")
    names = [f"void (anonymous namespace)::moe_gemm_kernel<{gated}>(CUtensorMap_st, "
             "CUtensorMap_st, (anonymous namespace)::MoeArgs)" for gated in ("true", "false")]
    assert all(metric.KERNEL in n and tracing.group_of(n) == "matmul" for n in names)
    assert chip_smoke.SASS_CHECKS[metric.KERNEL][0] == len(names)
