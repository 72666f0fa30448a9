"""The kernels granite-4.0-h adds or widens: the grouped expert products
(``ops.moe_experts``, ``csrc/moe.cu``) and ``ssd_scan`` at state 128.

On the CPU the wrappers run their plain versions: the grouped products'
against ``moe.moe_dropless_plain``, a loop over experts that never sorts,
on ragged expert counts (an expert with no rows, one with every token);
the scan's at N = 128 against the chunked form (``ssm.ssd_chunked``).  On a card (marked
``card``; they skip here) the CUDA kernels run against their plain
versions (``kernels/ref.py``).  Tolerance: ``tests/test_kernels.py``'s
float32 2e-5, of the largest value."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import moe, ssm

TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _experts(T, D, F, E, held, K, device, seed=0, one_expert=False):
    """Routed inputs and weights; ``one_expert``: every token's first choice
    is expert 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(T, D, generator=g, device=device) + 0.05
    router = torch.randn(D, E, generator=g, device=device) / D ** 0.5
    if one_expert:
        router[:, 1] = 1.0
    w = [torch.randn(held, D, F, generator=g, device=device) / D ** 0.5 for _ in range(2)]
    wd = torch.randn(held, F, D, generator=g, device=device) / F ** 0.5
    tok, gates, offsets, pos = moe.route_sorted(router, x, K, held)
    return (x, tok, offsets, gates, pos, *w, wd), router


@pytest.mark.parametrize("one_expert", [False, True])
def test_grouped_products_plain_path_matches_a_dense_loop(one_expert):
    T, D, F, E, held, K = 37, 64, 32, 8, 3, 3
    args, router = _experts(T, D, F, E, held, K, "cpu", seed=1, one_expert=one_expert)
    rows = (args[2][1:] - args[2][:-1]).tolist()
    if one_expert:
        assert rows[1] == T                  # expert 1 takes every token, none dropped
    p = {"router": router, "w_gate": args[5], "w_up": args[6], "w_down": args[7]}
    cfg = get_config("granite-4.0-h-small").replace(d_model=D, d_ff=F, n_experts=E,
                                                    experts_held=held, top_k=K)
    with torch.inference_mode():
        y = ops.moe_experts(*args)
        want = moe.moe_dropless_plain(p, args[0][None], cfg)[0]
    assert _rel(y, want) <= TOL
    assert ops.launch_counts()["moe_experts"] == 0


def test_ssd_scan_plain_path_at_state_128():
    """xdt, B and C as the Mamba2 block passes them (group form expanded
    over the heads), from an initial state, over a ragged 70 steps."""
    g = torch.Generator().manual_seed(2)
    B, S, H, hd, N = 2, 70, 4, 64, 128
    xh = torch.randn(B, S, H, hd, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.1
    dA = -dt * torch.rand(H, generator=g) * 4
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    h0 = torch.randn(B, H, hd, N, generator=g) * 0.1
    e = lambda m: m[:, :, None].expand(B, S, H, N)
    with torch.inference_mode():
        y, h = ops.ssd_scan(xh * dt[..., None], e(Bm), e(Cm), dA, h0=h0)
        y_c, h_c = ssm.ssd_chunked(xh, Bm, Cm, dt, dA, q=32, h0=h0)
    assert _rel(y, y_c) <= TOL and _rel(h, h_c) <= TOL


@pytest.mark.card
@pytest.mark.parametrize("one_expert", [False, True])
def test_grouped_kernel_matches_plain_on_card(one_expert, card):
    """At granite-4.0-h-small's widths and a cell's tokens (24 x 64), 18 of
    72 experts held, top-10: the three launches against the plain version."""
    T, D, F, E, held, K = 1536, 4096, 768, 72, 18, 10
    args, _ = _experts(T, D, F, E, held, K, card, seed=3, one_expert=one_expert)
    before = ops.launch_counts()["moe_experts"]
    with torch.inference_mode():
        y = ops.moe_experts(*args)
        want = ref.moe_experts_ref(*args)
    assert ops.launch_counts()["moe_experts"] == before + 1
    assert _rel(y, want) <= TOL


@pytest.mark.card
def test_ssd_scan_at_state_128_on_card(card):
    g = torch.Generator(device=card).manual_seed(4)
    B, S, H, hd, N = 2, 130, 128, 64, 128
    xdt = torch.randn(B, S, H, hd, generator=g, device=card) * 0.1
    Bm = torch.randn(B, S, N, generator=g, device=card)
    Cm = torch.randn(B, S, N, generator=g, device=card)
    dA = -torch.rand(B, S, H, generator=g, device=card) * 0.2
    h0 = torch.randn(B, H, hd, N, generator=g, device=card) * 0.1
    e = lambda m: m[:, :, None].expand(B, S, H, N)
    with torch.inference_mode():
        y, h = ops.ssd_scan(xdt, e(Bm), e(Cm), dA, h0=h0)
        y_r, h_r = ref.ssd_ref(xdt, e(Bm), e(Cm), dA, h0)
    assert _rel(y, y_r) <= TOL and _rel(h, h_r) <= TOL
