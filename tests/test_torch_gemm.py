"""The 3xTF32 product kernel's plain version, ``layers.mm``'s routing to it,
its counters and its name in the benchmark's trace groups.  Plain PyTorch
on the CPU; the CUDA kernel runs on the card (the ``card`` case, and
``chip_smoke.py``)."""
import ctypes
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.kernels import gemm, ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# (K, N) of each cell's products through mm (qwen1.5-4b: q/k/v/o, gate/up,
# down; rwkv6-1.6b: r/k/v/g/o and cm_r, cm_k, cm_v, the token-shift LoRA;
# granite-4.0-h-small: Mamba2 in / out, the shared expert, attention), K
# whole, N cut to 512 columns
CELL_SHAPES = [(2560, 2560), (2560, 6912), (6912, 2560),
               (2048, 2048), (2048, 7168), (7168, 2048), (2048, 160),
               (4096, 16768), (8192, 4096), (4096, 1536), (1536, 4096), (4096, 1024)]


def _err(y, y64):
    return ((y.double() - y64).abs().max() / y64.abs().max()).item()


def _operands(T, K, N, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, K, generator=g, device=device)
    w = torch.randn(K, N, generator=g, device=device) / K ** 0.5
    return x, w


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_3xtf32_against_float64(device):
    """The plain version (the CPU), or the kernel (the card), at each cell's
    K, T cut: its error against float64 is at most twice float32 x @ w's;
    on the card also the plain version's, at the plan's split of K, within
    float32's rounding, and two calls bit for bit equal."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    for K, N in CELL_SHAPES:
        T, N = (16, min(N, 512)) if device == "cpu" else (384, N)
        x, w = _operands(T, K, N, seed=K + N, device=device)
        y64 = x.double() @ w.double()
        with torch.inference_mode():
            y = ops.gemm(x, w)
            assert _err(y, y64) <= 2 * _err(x @ w, y64), (K, N)
            if device == "cuda":
                sms = torch.cuda.get_device_properties(x.device).multi_processor_count
                plain = ref.gemm_ref(x, w, splits=gemm.plan(T, K, N, sms)[0])
                assert _err(y, plain.double()) <= 2e-6, (K, N)
                assert torch.equal(y, ops.gemm(x, w)), (K, N)


class _FakeLib:
    """``repro_gemm`` on the CPU: the plain version written through y's
    pointer, each call's plan kept."""

    def __init__(self, x, w):
        self.x, self.w, self.calls = x, w, []

    def repro_gemm(self, call, xp, wp, yp):
        c = gemm._Call.from_address(call)
        assert (xp, wp) == (self.x.data_ptr(), self.w.data_ptr())
        self.calls.append((c.T, c.K, c.N, c.splits, c.kps, c.grid, bool(c.ws), bool(c.counters)))
        y = ref.gemm_ref(self.x.view(c.T, c.K), self.w, splits=c.splits)
        ctypes.memmove(yp, y.data_ptr(), y.numel() * 4)
        return 0


@pytest.fixture
def on_fake_card(monkeypatch):
    """``take`` routes CPU tensors to a fake library on a fake 132-SM card 0."""
    monkeypatch.setattr(gemm, "_card", lambda t: 0)
    monkeypatch.setattr(gemm, "_sm_count", lambda card: 132)
    monkeypatch.setattr(gemm, "_stream", lambda card: 7)
    for name in ("_scratch", "_calls"):
        monkeypatch.setattr(gemm, name, {})

    def install(x, w):
        lib = _FakeLib(x, w)
        monkeypatch.setattr(gemm._build, "load", lambda: lib)
        return lib
    return install


ROUTES = {  # case: (leading dims of x, K, N, routed)
    "eligible": ((3, 128), 256, 384, True),
    "t_below_64": ((63,), 256, 384, False),
    "t_64": ((64,), 128, 128, True),
    "k_below_128": ((128,), 64, 384, False),
    "n_below_128": ((128,), 256, 72, False),
    "n_not_multiple_of_4": ((128,), 256, 386, False),
    "k_not_multiple_of_4": ((128,), 258, 384, False),
    "grad": ((128,), 256, 384, False),
    "dtensor": ((128,), 256, 384, False),
    "bfloat16": ((128,), 256, 384, False),
    "cpu": ((128,), 256, 384, False),
}


def test_mm_routes_by_the_shape_rule(on_fake_card, monkeypatch):
    """``layers.mm`` sends a plain float32 product on the card to the kernel
    when T >= 64, K and N >= 128 and multiples of 4, and no gradient is
    wanted; every other product stays x @ w (the CPU's bit for bit), and a
    float32 pair on the card that is not taken is counted as declined."""
    counted = ("t_below_64", "k_below_128", "n_below_128", "n_not_multiple_of_4",
               "k_not_multiple_of_4", "grad")
    for case, (lead, K, N, routed) in ROUTES.items():
        x, w = _operands(int(torch.tensor(lead).prod()), K, N, seed=len(case))
        x = x.view(*lead, K)
        if case == "bfloat16":
            x, w = x.bfloat16(), w.bfloat16()
        if case == "grad":
            w.requires_grad_(True)
        with monkeypatch.context() as m:
            lib = on_fake_card(x, w)
            if case == "dtensor":
                m.setattr(gemm, "is_dtensor", lambda t: t is w)
            if case == "cpu":
                m.setattr(gemm, "_card", torch.Tensor.get_device)
            ops.reset_launch_counts()
            y = layers.mm(x, w)
            launched = (ops.launch_counts()["gemm"], gemm.gemm.declined)
        assert launched == (int(routed), int(case in counted)), case
        assert y.shape == (*lead, N) and len(lib.calls) == int(routed), case
        if routed:
            splits = gemm.plan(x.numel() // K, K, N, 132)[0]
            want = ref.gemm_ref(x.view(-1, K), w, splits=splits).view(*lead, N)
        else:
            want = x @ w
        assert torch.equal(y, want), case


def test_launch_counters_and_plan(on_fake_card):
    """Each routed product is one launch with ``plan``'s split of K (parts
    never empty; the workspace and counters only when split); declined
    calls count apart, and ``reset_launch_counts`` clears both.  The split
    fills the card: qwen1.5-4b's q/k/v/o at T = 384 make 60 tiles, split in
    two."""
    for T, K, N in ((384, 2560, 2560), (768, 2048, 160), (1536, 4096, 16768), (130, 1000, 300)):
        splits, kps, grid, tiles = gemm.plan(T, K, N, 132)
        kiters = -(-K // gemm.BK)
        assert 1 <= splits <= gemm.MAX_SPLITS and (splits - 1) * kps < kiters <= splits * kps
        assert tiles == -(-T // 128) * -(-N // 128) and grid == min(132, tiles * splits)
    assert gemm.plan(384, 2560, 2560, 132)[:3] == (2, 40, 120)
    assert gemm.plan(1536, 4096, 16768, 132)[0] == 1
    x, w = _operands(384, 2560, 256, seed=3)
    lib = on_fake_card(x, w)
    ops.reset_launch_counts()
    with torch.inference_mode():
        for _ in range(3):
            layers.mm(x, w)
        layers.mm(x[:32], w)
    assert ops.launch_counts()["gemm"] == 3 and gemm.gemm.declined == 1
    splits, kps, grid, _ = gemm.plan(384, 2560, 256, 132)
    assert lib.calls == [(384, 2560, 256, splits, kps, grid, splits > 1, splits > 1)] * 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["gemm"] == 0 and gemm.gemm.declined == 0


def test_kernel_name_is_a_matmul_in_the_trace():
    """The benchmark's trace groups the kernel's time with the products
    (``matmul``), and with no other group."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "perfbench"))
    from harness import tracing
    name = f"void (anonymous namespace)::{gemm.KERNEL_NAME}(CUtensorMap_st, CUtensorMap_st, " \
           "(anonymous namespace)::GemmArgs)"
    assert tracing.group_of(name) == "matmul"
    assert not any(key in gemm.KERNEL_NAME for key in (*tracing.KERNEL_GROUPS, "moe_gemm_kernel"))
    src = (Path(gemm.__file__).parent / "csrc" / "gemm.cu").read_text()
    assert f"{gemm.KERNEL_NAME}(const __grid_constant__" in src
