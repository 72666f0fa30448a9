"""Dropless MoE on Hopper: wrapper of the grouped expert products
``moe_gemm_kernel`` and their combine ``moe_combine_kernel``.

Replaces no TPU kernel: the JAX package's MoE layer is capacity-dropping
einsums, which the port keeps for mixtral and dbrx (``models/moe.py``
``apply_moe``).  A dropless layer (granite-4.0-h, DeepSeek-V2) computes
every assignment to a held expert, so each expert's rows are known only on
the device; cuBLAS takes a product's rows from the host.  This computes,
over assignments sorted by expert,

    h_r = silu(x_tok(r) W_gate[e]) * (x_tok(r) W_up[e]),   o_r = gate_r (h_r W_down[e]),
    y_t = sum over k of o_pos(t, k) where that row belongs to a held expert,

with the rows of held expert e at ``offsets[e] .. offsets[e + 1] - 1``.  On
a CUDA tensor it launches ``csrc/moe.cu`` (three kernels a call: the gate
and up products with the SwiGLU epilogue, the down product with the gate
weight, each a persistent grid of 3xTF32 wgmma blocks that builds its list
of (expert, column slice, token tile) units from the offsets on the device,
so the host never reads a count; then the combine); on a CPU tensor it runs
the plain ``ref.moe_experts_ref``.  Float32 only on the card.  No backward:
the dropless layer serves, it does not train.

A unit's token tile is ``TILE_ROWS`` of an expert's rows: each held
expert's weights are streamed once a tile of its rows.  48 rows beat 64
and 128 on an H100 at both MoE cells' shapes (PERF.md).

The launch goes through the custom op ``torch.ops.repro.moe_experts`` (a
fake implementation for ``FakeTensorMode`` and meta tensors).

``moe_experts.launches`` counts calls (three kernel launches each).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

TILE_ROWS = 48                 # csrc/moe.cu's MG_BT: a unit's token tile (wgmma's n)
COLS_UP, COLS_DOWN = 64, 128   # a unit's columns of h (so F's multiple) and of y (D's)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _validate(x, tok, offsets, gates, pos, w_gate, w_up, w_down):
    if x.dim() != 2 or pos.dim() != 2 or pos.shape[0] != x.shape[0]:
        raise ValueError("moe_experts: x (T, D) and pos (T, K)")
    T, D = x.shape
    A = tok.shape[0]
    E, _, F = w_gate.shape
    if A != pos.numel() or tuple(gates.shape) != (A,) or tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"moe_experts: tok {tuple(tok.shape)}, gates {tuple(gates.shape)}, "
                         f"offsets {tuple(offsets.shape)} disagree with pos "
                         f"{tuple(pos.shape)} and {E} experts")
    if tuple(w_gate.shape) != (E, D, F) or tuple(w_up.shape) != (E, D, F) \
            or tuple(w_down.shape) != (E, F, D):
        raise ValueError(f"moe_experts: weights {tuple(w_gate.shape)} {tuple(w_up.shape)} "
                         f"{tuple(w_down.shape)} for D = {D}")
    tensors = (x, tok, offsets, gates, pos, w_gate, w_up, w_down)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("moe_experts: tensors on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("moe_experts: an input requires grad; the dropless MoE layer "
                           "has no backward (it serves, it does not train)")


def moe_experts(x, tok, offsets, gates, pos, w_gate, w_up, w_down):
    """x: (T, D); tok (A,) int, gates (A,) float32: each sorted assignment's
    token and gate; offsets (E_held + 1,) int: held expert e's rows;
    pos (T, K) int: each (token, k) assignment's sorted row; w_gate, w_up
    (E_held, D, F), w_down (E_held, F, D).  Returns y (T, D) float32."""
    _validate(x, tok, offsets, gates, pos, w_gate, w_up, w_down)
    _build.check_device("moe_experts", x)
    return _moe_op(x, tok, offsets, gates, pos, w_gate, w_up, w_down)


@torch.library.custom_op("repro::moe_experts", mutates_args=())
def _moe_op(x: torch.Tensor, tok: torch.Tensor, offsets: torch.Tensor, gates: torch.Tensor,
            pos: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.moe_experts_ref(x, tok, offsets, gates, pos, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {x.device}")
    if any(t.dtype != torch.float32 for t in (x, gates, w_gate, w_up, w_down)):
        raise TypeError("moe_experts: float32 activations, gates and weights")
    T, D = x.shape
    E, _, F = w_gate.shape
    K = pos.shape[1]
    if D % COLS_DOWN or F % COLS_UP:
        raise ValueError(f"moe_experts: D = {D} must be a multiple of {COLS_DOWN} and "
                         f"F = {F} of {COLS_UP}")
    lib = _build.load()
    i32 = lambda t: t.to(torch.int32).contiguous()
    x, gates = x.contiguous(), gates.contiguous()
    w_gate, w_up, w_down = (w.contiguous() for w in (w_gate, w_up, w_down))
    tok, offsets, pos = i32(tok), i32(offsets), i32(pos)
    A = tok.shape[0]
    h = torch.empty((A, F), dtype=torch.float32, device=x.device)
    o = torch.empty((A, D), dtype=torch.float32, device=x.device)
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_moe_experts(
            T, D, F, K, E, _sm_count(x.device.index), x.data_ptr(),
            tok.data_ptr(), offsets.data_ptr(), gates.data_ptr(), pos.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), o.data_ptr(),
            y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_experts")
    moe_experts.launches += 1
    return y


@_moe_op.register_fake
def _(x, tok, offsets, gates, pos, w_gate, w_up, w_down):
    return x.new_empty(x.shape, dtype=torch.float32)


moe_experts.launches = 0
