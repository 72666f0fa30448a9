"""Flash-decode attention on Hopper: wrapper of ``decode_attn_kernel``.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``: one
query token per sequence against a KV cache, GQA, absolute kv positions
(-1 = never-written slot) and an optional sliding window.  On a CUDA
tensor it launches the CUDA kernel in ``csrc/attention.cu`` once: each
(batch, kv head)'s cache is cut into ``decode_split`` chunks, one block
each, and the blocks of a (batch, kv head) form one thread-block cluster
that combines their chunks in distributed shared memory.  On a CPU
tensor it runs the plain ``ref.decode_attention_ref``.  There is no
other path.

k and v may be any strided view whose head dimension is contiguous, so
the engine hands over its heads-major cache ``(B, KV, S, hd)`` as
``cache.k.transpose(1, 2)`` without a copy.

The launch goes through the custom op ``torch.ops.repro.decode_attention``
(a fake implementation for ``FakeTensorMode`` and meta tensors;
``sharding_rule`` and ``flops`` for ``kernels.ops.register_mesh_rules``).

``decode_attention.launches`` counts the calls that launched the kernel.

``decode_attention_partial`` (custom op ``repro::decode_attention_partial``)
is the same kernel over one segment of the slots, instantiated to write
its output in float32 beside the segment's log-sum-exp; its own counter
is ``decode_attention_partial.launches``.  ``combine_partials`` joins the
segments, on one card or, over a cache sharded across ranks by its slots,
with two all-reduces (``models/attention.py`` decodes so on a mesh).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ref import NEG_INF

TILE = 32                 # cache slots a block takes per step (DA_TILE in csrc/attention.cu)
MAX_CLUSTER = 8           # blocks of a thread-block cluster that any sm_90 card schedules


def decode_split(batch: int, kv_heads: int, slots: int, room) -> int:
    """Blocks per (batch, kv head), which run as one cluster.

    ``room[c - 1]`` is how many clusters of c blocks the card holds at once
    with one block on each SM (``cluster_room``): the SMs of a GPC take
    whole clusters, so clusters of 4 find room on 120 of an H100's 132
    SMs, not 128.  The busiest SM then runs ceil(pairs / room[c - 1])
    blocks of slots / c slots each; the choice minimises that, the larger
    c on a tie (more SMs busy), with at most ``MAX_CLUSTER`` blocks and at
    most one per ``TILE`` slots, so that no block is short.  A longer
    cache runs more steps per block."""
    pairs, tiles = batch * kv_heads, -(-slots // TILE)
    best = 1
    for c in range(2, min(MAX_CLUSTER, tiles) + 1):
        if room[c - 1] > 0 and (-(-pairs // room[c - 1]) * best
                                <= -(-pairs // room[best - 1]) * c):
            best = c
    return best


def block_slots(slots: int, cluster: int, rank: int) -> tuple:
    """Cache slots [lo, hi) of block ``rank`` of a cluster of ``cluster``,
    as the kernel cuts them: S / cluster slots each, rounded down at both
    ends."""
    return rank * slots // cluster, (rank + 1) * slots // cluster


@functools.lru_cache(maxsize=None)
def cluster_room(device_index: int) -> tuple:
    """(room for clusters of 1, 2, ..., MAX_CLUSTER blocks) on a CUDA card,
    from cudaOccupancyMaxActiveClusters at a footprint of one block per SM."""
    lib = _build.load()
    room = ctypes.c_int()
    out = []
    with torch.cuda.device(device_index):
        for c in range(1, MAX_CLUSTER + 1):
            _build.check(lib.repro_decode_cluster_room(c, ctypes.byref(room)), "decode_attention")
            out.append(room.value)
    return tuple(out)


def decode_cluster(batch: int, kv_heads: int, slots: int, device: torch.device) -> int:
    """The cluster size ``decode_attention`` launches with on ``device``."""
    return decode_split(batch, kv_heads, slots, cluster_room(device.index or 0))


def _validate(q, k, v, q_positions, kv_positions, window):
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q (B,1,H,hd), k/v (B,S,KV,hd)")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} disagree")
    if tuple(q_positions.shape) != (B,) or tuple(kv_positions.shape) != (B, S):
        raise ValueError("decode_attention: q_positions (B,), kv_positions (B,S)")
    devs = {t.device for t in (q, k, v, q_positions, kv_positions)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention: tensors on devices {devs}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("decode_attention: q, k, v of different dtypes")


def decode_attention(q, k, v, q_positions, kv_positions, *,
                     window: Optional[int] = None):
    """q: (B, 1, H, hd); k, v: (B, S, KV, hd); q_positions: (B,) int32;
    kv_positions: (B, S) int32.  Returns (B, 1, H, hd)."""
    _validate(q, k, v, q_positions, kv_positions, window)
    _build.check_device("decode_attention", q)
    return _decode_op(q, k, v, q_positions, kv_positions, window)


@torch.library.custom_op("repro::decode_attention", mutates_args=())
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
               kv_positions: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, q_positions, kv_positions,
                                        window=window).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, q_positions, kv_positions, window, out, None)
    decode_attention.launches += 1
    return out


def _launch(q, k, v, q_positions, kv_positions, window, out, lse):
    """One launch of ``decode_attn_kernel`` on CUDA tensors: the served
    kernel when ``lse`` is None, else its partial variant (float32 ``out``
    and ``lse``)."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not in {list(DTYPES)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: the head dimension must be contiguous")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("decode_attention: positions must be int32")
    q_positions = q_positions.contiguous()
    if kv_positions.stride(1) != 1:
        kv_positions = kv_positions.contiguous()
    _build.check_vector_aligned("decode_attention", q, (0, 2))
    for t in (k, v):
        _build.check_vector_aligned("decode_attention", t, (0, 1, 2))
    lib = _build.load()
    cluster = decode_cluster(B, KV, S, q.device)
    strides = _build.strides_arg((q, (0, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                                 (kv_positions, (0,)))
    args = (DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr())
    rest = (cluster, B, S, H, KV, strides, 0 if window is None else window,
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(q.device):
        if lse is None:
            err = lib.repro_decode_attention(*args, *rest)
        else:
            err = lib.repro_decode_attention_partial(*args, lse.data_ptr(), *rest)
    _build.check(err, "decode_attention")


@_decode_op.register_fake
def _(q, k, v, q_positions, kv_positions, window):
    return q.new_empty(q.shape)


def flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    """QKᵀ and PV against every cache slot, 2 flops per FMA: which slots
    are valid is data the count does not read (``chip_smoke.py``'s bound
    counts only the valid ones)."""
    B, _, H, hd = q_shape
    return 4 * hd * H * B * k_shape[1]


def sharding_rule(q, k, v, q_positions, kv_positions, window):
    """Batch may shard (positions with it), and heads as for
    ``flash_attention``; the cache's slots and the head dimension may not."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    out = [([R], [R, R, R, R, R, None]),
           ([Shard(0)], [Shard(0), Shard(0), Shard(0), Shard(0), Shard(0), None])]
    H, KV = q.shape[2], k.shape[2]
    if H == KV or KV % q.mesh.size() == 0:
        out.append(([Shard(2)], [Shard(2), Shard(2), Shard(2), R, R, None]))
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# The partial variant: one segment of a cache's slots, combined afterwards
# ---------------------------------------------------------------------------

def decode_attention_partial(q, k, v, q_positions, kv_positions, *,
                             window: Optional[int] = None):
    """``decode_attention`` over one segment of the slots (a rank's shard of
    a cache sharded over its slots): returns (o (B, 1, H, hd) float32, lse
    (B, H) float32), o normalised over the segment and lse its log-sum-exp,
    NEG_INF where the segment holds no valid slot for the row.
    ``combine_partials`` joins segments.  The same kernel as the served
    call, instantiated to write float32 and lse.  It runs on a rank's
    local shard, so meta tensors (the dry run's shards) are taken too and
    reach the fake implementation."""
    _validate(q, k, v, q_positions, kv_positions, window)
    if q.device.type != "meta":
        _build.check_device("decode_attention_partial", q)
    return _decode_partial_op(q, k, v, q_positions, kv_positions, window)


@torch.library.custom_op("repro::decode_attention_partial", mutates_args=())
def _decode_partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor,
                       window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        o, lse = ref.decode_attention_partial_ref(q, k, v, q_positions, kv_positions,
                                                  window=window)
        return o.contiguous(), lse.contiguous()
    B, _, H, _ = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    _launch(q, k, v, q_positions, kv_positions, window, out, lse)
    decode_attention_partial.launches += 1
    return out, lse


@_decode_partial_op.register_fake
def _(q, k, v, q_positions, kv_positions, window):
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:1] + q.shape[2:3], dtype=torch.float32))


def combine_partials(o, lse, slots, group=None):
    """Join ``decode_attention_partial``'s segments into what
    ``decode_attention`` gives on the whole cache, in float32: with M the
    largest lse, segment s weighs w_s = exp(lse_s - M) and the output is
    sum w_s o_s / sum w_s.  Where no segment holds a valid slot (M is
    NEG_INF) the segments weigh their slot counts ``slots``, which gives
    mean(V) over the whole cache, as the kernel does; a segment with no
    valid slot beside one that has weighs exp(NEG_INF - M) = 0.

    Without ``group``, o (n, B, 1, H, hd) and lse (n, B, H) stack n
    segments and ``slots`` holds their n slot counts.  With ``group`` (a
    ``(DeviceMesh, mesh dim)`` that shards the slots), o and lse are this
    rank's segment, ``slots`` its slot count, and the max and the sums are
    ``_c10d_functional`` all-reduces over that group: one of lse, one of
    the weighted outputs and weights packed together."""
    if group is None:
        n = o.shape[0]
        slots = torch.as_tensor(slots, dtype=torch.float32, device=o.device).reshape(n, 1, 1)
        big = lse.amax(0)
        w = torch.where(big > NEG_INF / 2, torch.exp(lse - big), slots)
        num = (w[..., None] * o[:, :, 0]).sum(0)
        return (num / w.sum(0)[..., None])[:, None]
    import torch.distributed._functional_collectives as funcol
    big = funcol.wait_tensor(funcol.all_reduce(lse, "max", group))
    w = torch.where(big > NEG_INF / 2, torch.exp(lse - big), float(slots))
    packed = torch.cat([w[..., None] * o[:, 0], w[..., None]], dim=-1)
    packed = funcol.wait_tensor(funcol.all_reduce(packed, "sum", group))
    return (packed[..., :-1] / packed[..., -1:])[:, None]


decode_attention_partial.launches = 0
