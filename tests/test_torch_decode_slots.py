"""Decode over a cache cut into slot segments: the partial kernel's plain
version and ``combine_partials``, and the dry run of a decode step whose
cache is sharded over its slots.

``decode_attention_partial`` attends one segment of the slots and returns
its output in float32 beside its log-sum-exp; ``combine_partials`` joins
the segments.  On a mesh the segments are the ranks' shards of a cache
sharded over its slots (``models/attention.py``), joined by two
all-reduces, so the cache is never gathered.  The CUDA kernel's partial
variant runs only on the card (``chip_smoke.py`` holds it against this
plain version there).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import combine_partials
from repro_torch.models.attention import _slot_positions, _valid_positions

REPO = Path(__file__).resolve().parents[1]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py's bounds
SEGMENTS = (1, 2, 4, 7)


def _inputs(rng, B, S, H, KV, hd, dt, *, rolling=False, empty_row=None):
    """q, k, v, q positions, kv positions and the sequences' next position:
    a linear buffer at positions 0..S-1 (slots at or past each row's
    position unwritten), or a rolling buffer of S slots past its first
    wrap; ``empty_row`` has no valid slot."""
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
    q, k, v = t(B, 1, H, hd), t(B, S, KV, hd), t(B, S, KV, hd)
    pos = torch.from_numpy(rng.integers(S // 3, S, size=B).astype(np.int32))
    if rolling:
        pos = pos + S + 5                       # every slot written once, some twice
    slots = torch.arange(S, dtype=torch.int32)
    kv_pos = _valid_positions(_slot_positions(slots, pos, S, rolling), pos, rolling)
    if empty_row is not None:
        kv_pos[empty_row] = -1
    return q, k, v, pos - 1, kv_pos, pos


def _segments(n, S):
    cuts = np.linspace(0, S, n + 1).astype(int)
    return list(zip(cuts[:-1], cuts[1:]))


def _combined(q, k, v, q_pos, kv_pos, window, n):
    """The plain partial version over n segments, joined."""
    parts = [ref.decode_attention_partial_ref(q, k[:, a:b], v[:, a:b], q_pos, kv_pos[:, a:b],
                                              window=window) for a, b in _segments(n, k.shape[1])]
    o, lse = (torch.stack(x) for x in zip(*parts))
    return combine_partials(o, lse, [b - a for a, b in _segments(n, k.shape[1])]), lse


def test_segments_combine_to_the_whole_cache():
    """Over 1, 2, 4 and 7 segments, at 1, 4 and 7 query heads a kv head,
    with and without a window, on a linear and on a rolling buffer: the
    combined output equals ``decode_attention_ref`` on the whole cache
    (f32 2e-5, bf16 2e-2).  The rolling buffer's segments take their slots'
    positions from their own offset (``_slot_positions`` of a shard's
    slots), as a rank of a mesh does."""
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for G in (1, 4, 7):
            for window, rolling in ((None, False), (24, False), (None, True), (40, True)):
                B, S, KV, hd = 3, 150, 2, 32
                q, k, v, q_pos, kv_pos, pos = _inputs(rng, B, S, G * KV, KV, hd, dt,
                                                      rolling=rolling)
                want = ref.decode_attention_ref(q, k, v, q_pos, kv_pos, window=window).float()
                for n in SEGMENTS:
                    # each segment's positions from its own slots, as a shard's
                    seg_pos = torch.cat([_valid_positions(_slot_positions(
                        torch.arange(a, b, dtype=torch.int32), pos, S, rolling), pos, rolling)
                        for a, b in _segments(n, S)], dim=1)
                    assert torch.equal(seg_pos, kv_pos)
                    got, _ = _combined(q, k, v, q_pos, seg_pos, window, n)
                    err = float((got - want).abs().max())
                    assert err <= TOL[dt], (dt, G, window, rolling, n, err)


def test_empty_segments_and_rows_weigh_nothing():
    """Segments with no valid slot (a short prompt in a long cache, a
    window) get lse = NEG_INF and weigh nothing beside a segment that has
    one; a row with no valid slot anywhere gets mean(V) of the whole cache,
    as ``decode_attention_ref`` and the kernel give it."""
    rng = np.random.default_rng(1)
    for dt in (torch.float32, torch.bfloat16):
        B, S, H, KV, hd = 3, 256, 8, 2, 64
        q, k, v, _, kv_pos, _ = _inputs(rng, B, S, H, KV, hd, dt, empty_row=2)
        q_pos = torch.tensor([20, 9, 100], dtype=torch.int32)   # rows 0, 1: early in the cache
        for window in (None, 8):
            want = ref.decode_attention_ref(q, k, v, q_pos, kv_pos, window=window).float()
            mean_v = v[2].float().mean(0).repeat_interleave(H // KV, dim=0)
            assert float((want[2, 0] - mean_v).abs().max()) <= TOL[dt]
            for n in SEGMENTS:
                got, lse = _combined(q, k, v, q_pos, kv_pos, window, n)
                assert float((got - want).abs().max()) <= TOL[dt], (dt, window, n)
                for s, (a, b) in enumerate(_segments(n, S)):
                    if a > 20:                  # past every valid slot of rows 0, 1
                        assert bool((lse[s] == ref.NEG_INF).all()), (n, s)
                assert bool((lse[:, 2] == ref.NEG_INF).all())


def test_combined_segments_match_the_jax_reference():
    """The combined segments equal the JAX package's
    ``kernels.ref.decode_attention_ref`` on the same seeded numpy inputs
    (float32, 2e-5), window and no-valid-slot row included."""
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = 4, 200, 12, 4, 32
    q, k, v, q_pos, kv_pos, _ = _inputs(rng, B, S, H, KV, hd, torch.float32, empty_row=1)
    for window in (None, 30):
        want = np.asarray(jax_decode_ref(*(x.numpy() for x in (q, k, v, q_pos, kv_pos)),
                                         window=window))
        for n in SEGMENTS:
            got, _ = _combined(q, k, v, q_pos, kv_pos, window, n)
            assert float(np.max(np.abs(got.numpy() - want))) <= TOL[torch.float32], (window, n)


def test_decode_dry_run_gathers_no_cache(tmp_path):
    """The dry run of qwen3-4b decode_32k, cut to 2 layers, on the fake
    16x16 CPU mesh: each layer's cache (8 rows, 8 kv heads, 32768 slots,
    128) bf16 is sharded over its slots on the 16-way model axis.  A
    gather of K and V would move 2 x 2 x 512 MiB x 15/16 a device; the
    step's ring bytes stay under 1 % of that, its dominant term is not the
    collective one, and its saved ops (``--save-hlo-dir``) hold no
    all-gather whose output has the cache's slot count, and each layer one
    partial kernel on its local 2048 slots."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b",
         "--shape", "decode_32k", "--layers", "2", "--out", str(tmp_path / "rec.json"),
         "--save-hlo-dir", str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        timeout=600, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                          "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    (rec,) = json.loads((tmp_path / "rec.json").read_text())
    assert rec["status"] == "ok" and rec["layers"] == 2 and rec["mesh"] == "16x16", rec
    gather = 2 * 2 * (8 * 8 * 32768 * 128 * 2) * 15 / 16
    assert rec["collective_bytes_per_dev"] < 0.01 * gather, rec
    assert rec["dominant"] != "collective", rec
    ops = [json.loads(line) for line in (tmp_path / "qwen3-4b_decode_32k_16x16.ops").open()]
    gathers = [r for r in ops if r.get("collective") == "all-gather"]
    assert gathers and not any("32768" in s for r in gathers for s in r["out"]), gathers
    partial = [r for r in ops if r["op"].startswith("repro.decode_attention_partial")]
    assert len(partial) == 2 and all(r["in"][1] == "bf16[8,2048,8,128]" for r in partial), \
        partial
    assert not any(r["op"].startswith("repro.decode_attention.") for r in ops)
