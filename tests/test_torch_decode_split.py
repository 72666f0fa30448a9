"""The decode kernel's split and combine, checked on the CPU.

``decode_attn_kernel`` (``csrc/attention.cu``) runs only on the card, so
what surrounds it is held here: the host's choice of blocks per (batch,
kv head) and their slot ranges (``decode_split`` / ``block_slots``), the
lane layout of its score pass, and its arithmetic (each warp's online
softmax over its rows, the block's and then the cluster's combine),
emulated in float32 torch and held against the Pallas kernel in interpret
mode.  Also: ``chip_smoke.py`` alone, without the port beside it, exits 1
and says why.  Each test loops over its cases (see tests/_torch_parity.py
for why).
"""
import math
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from repro.kernels.decode_attention import decode_attention as jax_decode
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (MAX_CLUSTER, TILE, block_slots,
                                                  decode_split)

REPO = Path(__file__).resolve().parents[1]
NEG_INF = -1e30
WARPS, ROWS = 8, 4             # the kernel's warps per block and rows per warp step
# cudaOccupancyMaxActiveClusters on an H100 SXM (132 SMs) for clusters of
# 1..8 blocks at one block per SM (decode_attention.cluster_room)
H100_ROOM = (132, 66, 39, 30, 22, 17, 15, 15)
SMS = 132


SHAPES = [  # (batch, kv heads, served at 524 slots)
    (4, 8, True),              # qwen3-4b: 32 (batch, kv head) pairs
    (4, 32, True),             # zamba2-2.7b's shared attention: 128 pairs
    (2, 2, False), (2, 8, False), (2, 1, False), (2, 32, False),   # chip_smoke's grid
    (1, 1, False),
]


def test_decode_split_covers_the_cache():
    """For every S up to 4096: at most MAX_CLUSTER blocks and no more than
    one per tile, each with slots, covering [0, S) once in order; at the
    served shapes more blocks than SMs, each cluster in room at the
    kernel's three blocks an SM (one wave)."""
    for batch, kv_heads, served in SHAPES:
        for slots in range(1, 4097):
            c = decode_split(batch, kv_heads, slots, H100_ROOM)
            case = (batch, kv_heads, slots, c)
            assert 1 <= c <= min(MAX_CLUSTER, -(-slots // TILE)), case
            ranges = [block_slots(slots, c, r) for r in range(c)]
            assert ranges[0][0] == 0 and ranges[-1][1] == slots, case
            assert all(lo < hi for lo, hi in ranges), case
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), case
        if served:
            c = decode_split(batch, kv_heads, 524, H100_ROOM)
            pairs = batch * kv_heads
            assert pairs * c >= SMS and -(-pairs // H100_ROOM[c - 1]) <= 3, (batch, kv_heads, c)


def emulate(q, k, v, qpos, kvpos, window, cluster):
    """decode_attn_kernel's arithmetic in float32: block r of the cluster
    takes block_slots(S, cluster, r) in steps of TILE slots, warp w the
    rows [4 w, 4 w + 4) of each step with its own running max (from the
    finite NEG_INF) and sum; masked slots score NEG_INF, slots past the
    block's end -inf; the warps' and then the blocks' partials are
    combined, each weighed by exp(m - max m)."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = torch.empty((B, 1, H, hd), dtype=torch.float32)
    for b in range(B):
        for h in range(KV):
            qg = q[b, 0, h * G:(h + 1) * G].float()
            blocks = []
            for rank in range(cluster):
                lo, hi = block_slots(S, cluster, rank)
                warps = []
                for w in range(WARPS):
                    m, l = torch.full((G,), NEG_INF), torch.zeros(G)
                    acc = torch.zeros((G, hd))
                    for step in range(-(-(hi - lo) // TILE)):
                        rows = lo + step * TILE + ROWS * w + torch.arange(ROWS)
                        inside = rows < hi
                        rows = rows.clamp(max=S - 1)
                        pos = kvpos[b, rows]
                        ok = (pos >= 0) & (pos <= qpos[b])
                        if window is not None:
                            ok &= pos > qpos[b] - window
                        s = qg @ k[b, rows, h].float().T / math.sqrt(hd)
                        s = torch.where(inside, torch.where(ok, s, NEG_INF), -math.inf)
                        m_new = torch.maximum(m, s.max(1).values)
                        p = torch.exp(s - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(1)
                        acc = alpha[:, None] * acc + p @ v[b, rows, h].float()
                        m = m_new
                    warps.append((m, l, acc))
                blocks.append(_combine(warps))
            m, l, acc = _combine(blocks)
            out[b, 0, h * G:(h + 1) * G] = acc / l.clamp(min=1e-30)[:, None]
    return out


def _combine(parts):
    m = torch.stack([p[0] for p in parts]).max(0).values
    e = [torch.exp(p[0] - m) for p in parts]
    return (m, sum(ei * p[1] for ei, p in zip(e, parts)),
            sum(ei[:, None] * p[2] for ei, p in zip(e, parts)))


CASES = {  # name: (S, window, kvpos of row 0, kvpos of row 1, query positions)
    "rolling -1 slots": (200, None, "rolling", "rolling", (170, 199)),
    "a row with no valid slot": (200, None, "linear", "none", (150, 150)),
    "window 1": (200, 1, "linear", "linear", (77, 199)),
    "window shorter than a tile": (200, 20, "linear", "linear", (120, 199)),
    "valid slots only in the last block": (200, None, "last", "last", (199, 199)),
}


def test_split_combine_matches_pallas():
    """The emulated split (at decode_split's choice and at one block of
    many steps) against the Pallas kernel in interpret mode, within the f32
    tolerance 2e-5; a row with no valid slot returns mean(V)."""
    for case in CASES:
        _check_split_combine(case)


def _check_split_combine(case):
    S, window, row0, row1, qpos = CASES[case]
    B, H, KV, hd = 2, 4, 2, 32
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in [(B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)])
    cluster = decode_split(B, KV, S, H100_ROOM)
    assert cluster > 1
    last_lo = block_slots(S, cluster, cluster - 1)[0]
    slot = np.arange(S)
    kinds = {"linear": slot, "none": np.full(S, -1),
             "rolling": np.where(slot < 180, slot, -1),
             "last": np.where(slot >= last_lo, slot, -1)}
    kvpos = np.stack([kinds[row0], kinds[row1]]).astype(np.int32)
    qpos = np.asarray(qpos, np.int32)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(qpos), jnp.asarray(kvpos), window=window,
                                 bk=S, interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kvpos)
    for c in (cluster, 1):
        got = emulate(qt, kt, vt, qp, kp, window, c)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=f"{case} C={c}")
    np.testing.assert_allclose(ops.decode_attention(qt, kt, vt, qp, kp, window=window).numpy(),
                               want, atol=2e-5, rtol=2e-5)
    if row1 == "none":
        mean_v = np.repeat(v[1].mean(0), H // KV, axis=0)
        np.testing.assert_allclose(want[1, 0], mean_v, atol=2e-5)
    assert ref.NEG_INF == NEG_INF


def test_score_lanes_reduce_scatter():
    """The score pass's lane layout, at every head_dim and heads-per-pass:
    lane l loads chunk l % C4 of rows rr * RPI + l / LPR; after the
    reduce-scatter of shuffles (mask M: the lanes with bit M keep the upper
    half) lane l holds the dot product of row ((l % LPR) >> 3) * RPI + l /
    LPR and head (l >> log2 DUP) % gh, the four rows of a head in lane bits
    3 and 4."""
    for hd in (32, 64, 80, 128):
        for gh in (1, 4):
            _check_lanes(hd, gh)


def _check_lanes(hd, gh):
    c4 = hd // 4
    rpi = 32 // c4 if 32 % c4 == 0 else 1
    lpr, rpl = 32 // rpi, 4 // rpi
    npart, dup = rpl * gh, 8 // gh
    assert lpr == npart * dup
    rng = np.random.default_rng(hd + gh)
    K, Q = rng.standard_normal((4, hd)), rng.standard_normal((gh, hd))
    v = np.zeros((32, npart))
    for lane in range(32):
        if lane < rpi * c4:
            c = 4 * (lane % c4)
            for gg in range(gh):
                for rr in range(rpl):
                    v[lane, rr * gh + gg] = Q[gg, c:c + 4] @ K[rr * rpi + lane // lpr, c:c + 4]
    m, cnt = lpr // 2, npart
    lanes = np.arange(32)
    while m >= 1:
        partner = v[lanes ^ m]
        if cnt > 1:
            half = cnt // 2
            up = (lanes & m) != 0
            keep = np.where(up[:, None], v[:, half:cnt], v[:, :half])
            sent = np.where(up[:, None], partner[:, half:cnt], partner[:, :half])
            v = np.concatenate([keep + sent, v[:, half:]], axis=1)
            cnt = half
        else:
            v[:, 0] = v[:, 0] + partner[:, 0]
        m //= 2
    row = ((lanes % lpr) >> 3) * rpi + lanes // lpr
    head = (lanes >> int(math.log2(dup))) & (gh - 1)
    np.testing.assert_allclose(v[:, 0], np.einsum("ld,ld->l", Q[head], K[row]), atol=1e-12,
                               err_msg=f"hd {hd}, {gh} heads a pass")
    for base in range(8):                       # lanes differing in bits 3 and 4
        assert sorted(row[base + 8 * np.arange(4)]) == [0, 1, 2, 3], (hd, gh)


def test_chip_smoke_alone_names_the_missing_port(tmp_path):
    """A copy of chip_smoke.py without the repository beside it exits 1,
    prints no result and names the missing src/repro_torch."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc
    assert "src/repro_torch" in proc.stderr and proc.stdout == "", proc
