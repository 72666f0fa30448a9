"""Float32 products on Hopper's tensor cores: wrapper of ``dense_gemm_kernel``.

Replaces no TPU kernel: the JAX package leaves its products to XLA.  On
the card a float32 ``x @ w`` with TF32 off runs on the CUDA cores (cuBLAS's
SIMT sgemm, 67 TFLOP/s at most); ``csrc/gemm.cu`` runs it on the tensor
cores as 3xTF32 (three TF32 passes over hi / lo halves), float32-accurate,
bounded by 2 T K N operations at 165 TFLOP/s.  ``layers.mm`` sends it the
served products through ``take``; everything else stays ``x @ w``.

``gemm(x, w)``: x (T, K) @ w (K, N), float32.  A CUDA tensor launches the
kernel; a CPU tensor runs the plain ``ref.gemm_ref``.  No backward.

``plan`` splits K into 1 to ``MAX_SPLITS`` parts where the 128 x 128 tiles
alone would leave SMs idle; the parts meet in a workspace and a counter a
tile, kept per (device, stream) and zero between calls.

``gemm.launches`` counts launches; ``gemm.declined`` counts the plain CUDA
float32 products that ``take`` left to ``x @ w`` (the shape rule).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import _build, ref

KERNEL_NAME = "dense_gemm_kernel"   # csrc/gemm.cu: the device trace's name
BM, BT, BK = 128, 128, 32           # a tile: weight columns, tokens; a stage's depth
MIN_T, MIN_KN = 64, 128             # the shape rule's least tokens, and K and N
MAX_SPLITS = 8
# plan's costs, in a stage's time: a tile's epilogue; a split tile's part's
# write, count and the last part's read of the others, growing with the
# parts (fitted to the kernel's times at the three cells' shapes on an H100,
# splits 1 to 8: each shape's fastest split chosen)
EPILOGUE_STAGES, FIXUP_STAGES, FIXUP_STAGES_A_PART = 2, 2, 0.5


@functools.lru_cache(maxsize=None)
def plan(T: int, K: int, N: int, sms: int):
    """(splits, stages a part, grid, tiles) for a (T, K) x (K, N) product
    on ``sms`` SMs: the split of K whose units (tiles x splits) run in the
    fewest stages, counted in waves of ``sms`` units; no part empty."""
    tiles = -(-T // BT) * -(-N // BM)
    kiters = -(-K // BK)
    best = None
    for splits in range(1, MAX_SPLITS + 1):
        kps = -(-kiters // splits)
        if (splits - 1) * kps >= kiters:
            continue
        waves = -(-tiles * splits // sms)
        fixup = FIXUP_STAGES + FIXUP_STAGES_A_PART * (splits - 1) if splits > 1 else 0
        cost = waves * (kps + EPILOGUE_STAGES + fixup)
        if best is None or cost < best[0]:
            best = (cost, splits, kps)
    _, splits, kps = best
    return splits, kps, min(sms, tiles * splits), tiles


def fits(x, w) -> bool:
    """What the kernel takes: x (..., K) and w (K, N) contiguous, K and N
    multiples of 4, both on 16-byte boundaries (TMA's)."""
    xs, ws = x.shape, w.shape
    return (len(ws) == 2 and len(xs) >= 2 and xs[-1] == ws[0] and ws[0] > 0 and ws[1] > 0
            and not (ws[0] | ws[1]) & 3 and x.is_contiguous() and w.is_contiguous()
            and not (x.data_ptr() | w.data_ptr()) & 15)


def eligible(x, w) -> bool:
    """The shape rule of ``take``: x views as (T, K) with T >= 64, w is a
    (K, N) with K and N at least 128, and the kernel ``fits``."""
    return fits(x, w) and min(w.shape) >= MIN_KN and x.numel() >= MIN_T * w.shape[0]


def take(x, w):
    """``layers.mm``'s route for a float32 x: the kernel's x @ w where x and
    w are plain tensors on one card, w float32, no gradient is wanted and
    the shape rule holds; else None, and a pair on a card that is not taken
    is counted in ``gemm.declined``.  Lean: it runs once a product."""
    dev = _card(x)
    if dev < 0 or _card(w) != dev or is_dtensor(x) or is_dtensor(w):
        return None
    if (w.dtype == torch.float32 and eligible(x, w)
            and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))):
        K, N = w.shape
        y = x.new_empty((*x.shape[:-1], N))
        _launch(dev, x, w, y, x.numel() // K, K, N)
        return y
    gemm.declined += 1
    return None


def gemm(x, w):
    """x (T, K) @ w (K, N) -> (T, N) float32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: x (T, K) and w (K, N), got {tuple(x.shape)} {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("gemm: x and w on different devices")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("gemm: float32 x and w")
    _build.refuse_grad("gemm", "repro_torch.models.layers.mm", x, w)
    if x.device.type == "cpu":
        return ref.gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {x.device}")
    x, w = x.contiguous(), w.contiguous()
    if not fits(x, w):
        raise ValueError(f"gemm: no kernel for x {tuple(x.shape)} @ w {tuple(w.shape)} (K and "
                         "N multiples of 4, 16-byte aligned)")
    y = x.new_empty((x.shape[0], w.shape[1]))
    _launch(x.get_device(), x, w, y, *x.shape, w.shape[1])
    return y


_card = torch.Tensor.get_device      # a tensor's card, -1 off the cards (the CPU tests patch it)
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


_scratch = {}    # (card, stream) -> (counters, workspace)
_calls = {}      # (card, stream, T, K, N) -> address of its _Call (kept in _call_structs)
_call_structs = []


class _Call(ctypes.Structure):
    """``csrc/gemm.cu``'s GemmCall: a shape's plan, scratch and stream,
    made once, so a launch converts four arguments."""
    _fields_ = [("dev", ctypes.c_int), ("T", ctypes.c_int), ("K", ctypes.c_int),
                ("N", ctypes.c_int), ("splits", ctypes.c_int), ("kps", ctypes.c_int),
                ("grid", ctypes.c_int), ("ws", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("stream", ctypes.c_void_p)]


def _buffers(device, key, tiles, floats):
    """The tile counters (int32, zero between calls: the last part of a
    tile resets its own) and partial-tile workspace of ``key``, a (card,
    stream), grown to ``tiles`` and ``floats`` (the calls that point at
    smaller ones are made again)."""
    have = _scratch.get(key)
    if have is None or have[0].numel() < tiles or have[1].numel() < floats:
        n_c, n_w = (tiles, floats) if have is None else (max(tiles, have[0].numel()),
                                                          max(floats, have[1].numel()))
        have = (torch.zeros(n_c, dtype=torch.int32, device=device),
                torch.empty(n_w, dtype=torch.float32, device=device))
        _scratch[key] = have
        _calls.clear()
    return have


def _make_call(device, key):
    """The _Call of ``key``, a (card, stream, T, K, N)."""
    dev, stream, T, K, N = key
    splits, kps, grid, tiles = plan(T, K, N, _sm_count(dev))
    call = _Call(dev, T, K, N, splits, kps, grid, None, None, stream)
    if splits > 1:
        counters, ws = _buffers(device, (dev, stream), tiles, tiles * splits * BM * BT)
        call.counters, call.ws = counters.data_ptr(), ws.data_ptr()
    _call_structs.append(call)
    _calls[key] = ctypes.addressof(call)
    return _calls[key]


def _launch(dev, x, w, y, T, K, N):
    """y (T, N) = x (T, K) @ w (K, N) on card ``dev``: contiguous float32,
    the kernel ``fits``; on the current stream."""
    key = (dev, _stream(dev), T, K, N)
    call = _calls.get(key) or _make_call(x.device, key)
    err = _build.load().repro_gemm(call, x.data_ptr(), w.data_ptr(), y.data_ptr())
    if err:
        _build.check(err, "gemm")
    gemm.launches += 1


gemm.launches = 0
gemm.declined = 0
