"""The port's kernel wrappers: strided inputs, validation, launch counts
and the build target.  Plain PyTorch only; the CUDA kernels run on the
card in ``chip_smoke.py``."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.kernels import _build, ops  # noqa: E402


def test_decode_attention_reads_heads_major_view():
    """The engine passes its (B, KV, S, hd) cache as a strided view."""
    rng = np.random.default_rng(6)
    B, S, H, KV, hd = 2, 40, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    k_hm = torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(np.float32))
    v_hm = torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(np.float32))
    qpos = torch.tensor([20, 39], dtype=torch.int32)
    kvpos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    out = ops.decode_attention(q, k_hm.transpose(1, 2), v_hm.transpose(1, 2),
                               qpos, kvpos)
    dense = ops.decode_attention(q, k_hm.transpose(1, 2).contiguous(),
                                 v_hm.transpose(1, 2).contiguous(), qpos, kvpos)
    assert torch.equal(out, dense)


def test_wrappers_refuse_other_devices_and_bad_shapes():
    q = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError):
        ops.decode_attention(torch.zeros(1, 2, 2, 32), torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, 8, dtype=torch.int32))


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.zeros((1, 8, 2, 32))
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, :1], x, x, torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, 8, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "rwkv6_scan": 0, "ssd_scan": 0, "alloc_all": 0,
                                   "tables": 0}


def test_build_targets_hopper():
    """The kernels are compiled for sm_90a, one nvcc per source, into one
    library in the git-ignored build directory of this checkout, named by
    the sources' hash (built on the card's machine)."""
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-O3" in _build.NVCC_FLAGS
    assert {p.name for p in _build.SOURCES} == {"attention.cu", "scan.cu", "planner.cu",
                                                "physics.cu"}
    assert all(p.exists() for p in _build.SOURCES + _build.HEADERS)
    # only the float64 sources (the planner's grant loop and the simulator's
    # latency tables) are built without fused multiply-adds
    assert _build.SOURCE_FLAGS == {"planner.cu": ("--fmad=false",),
                                   "physics.cu": ("--fmad=false",)}
    assert "--fmad=false" not in _build.NVCC_FLAGS
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libreprokernels-")
    assert _build.BUILD_DIR == Path(__file__).resolve().parents[1] / "build" / "kernels"


# cudaOccupancyMaxActiveClusters on an H100 SXM (132 SMs) for clusters of
# 1..8 blocks at one block per SM (decode_attention.cluster_room)
H100_ROOM = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("batch, kv_heads, slots, want", [
    (4, 8, 524, 6),       # qwen3-4b's decode: 192 blocks; clusters of 8 would put 3 on some SMs
    (2, 8, 2000, 6),      # long cache: 16 clusters of 6 find room one block per SM
    (2, 2, 48, 2),        # one ragged tile and a bit: no block shorter than a tile
    (64, 8, 4096, 2),     # 512 (batch, kv head) pairs: several blocks per SM whatever the size
])
def test_decode_split_fills_the_card(batch, kv_heads, slots, want):
    from repro_torch.kernels.decode_attention import decode_split
    assert decode_split(batch, kv_heads, slots, H100_ROOM) == want
