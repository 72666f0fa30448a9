#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and exits non-zero):
  1. device   -- the card's name and power limit (nvidia-smi)
  2. build    -- nvcc builds the CUDA kernels from src/repro_torch/kernels/csrc,
                 one process per source, linked into one library; ptxas's
                 registers, shared memory and spills per kernel; the SASS
                 (cuobjdump -sass) of every instantiation of the three
                 tensor-core kernels (flash_attn_kernel, ssd_scan_kernel,
                 rwkv6_scan_kernel) must hold tensor-core products (HGMMA /
                 HMMA ... TF32), every decode_attn_kernel asynchronous
                 copies (LDGSTS, or TMA's UBLKCP / UTMALDG), and no
                 decode_attn_combine is left; TF32 stays off in torch
  3. kernels  -- each CUDA kernel against its plain PyTorch version on the
                 card: the shape grid of tests/test_kernels.py in f32 and
                 bf16 (attention 2e-5 / 2e-2, the two scans 5x that), a
                 ragged S, rolling slots with a row that has no valid slot,
                 caches cut into one chunk and into chunks of two tiles,
                 head_dim 80 (zamba2's shared attention), nonzero initial
                 states and a two-call continuation (f32 and bf16) for the
                 scans, B and C in group form (head stride 0), the edges of
                 the tensor-core tiling (flash: S = 1, 63, 65, 513, windows
                 of 1 and longer than S, 1/2/4/8 query heads per kv head at
                 every head_dim; ssd: S = 1, 40, 2048 and every (hd, N);
                 rwkv6: S = 1, 31, 33 at hd 32 and 64, S = 33 from a state;
                 decode: S = 1, 63, 65, 1, 4 and 16 query heads per kv
                 head at every head_dim, windows of 1 and 20, and at the
                 served shape valid
                 slots only in the cluster's last block and a row with no
                 valid slot, f32 and bf16), and each kernel at its served
                 model's own shapes; decode's cluster size at both served
                 shapes fills the card; inputs no kernel is built for raise
  4. slices   -- for each served model (qwen3-4b, rwkv6-1.6b, zamba2-2.7b)
                 at full width (full depth but for qwen3-4b: see MODELS;
                 f32, random weights from a torch.Generator on the card):
                 a reduced model on the card
                 must match the same model's plain CPU path (rel. err <=
                 1e-4); ServingEngine answers 16 requests in 4 pumps; the
                 kernels' launch counters are read over those pumps alone
                 and must be exactly what the model runs; the first decode
                 step's logits must equal a prefill over prompt + that token
                 (rel. err <= 1e-3); a reset cache must give a fresh cache's
                 logits bit for bit, and a fifth pump of the first pump's
                 prompts the first pump's tokens; one prefill and one decode
                 step alone, on the host clock and under torch.profiler.
                 Each model's engine is freed before the next one loads.
  5. timing   -- (run between phases 3 and 4, before any pump is profiled)
                 device time (torch.profiler) of each kernel, its plain
                 version and, for attention, one PyTorch library call
                 (scaled_dot_product_attention under its efficient backend
                 on K/V expanded to every query head, a yardstick the port
                 never calls; the math-backend time of the enable_gqa call
                 beside it where H > KV; no single call computes a scan) at
                 the served shapes, beside the least time the card could
                 take (bound_ms at the 3xTF32 rate, bound_f32_cores_ms at
                 the CUDA cores' float32 rate); attention also at zamba2's
                 head_dim 80; one decode call launches exactly one kernel
  6. planner  -- (run after phase 5, before phase 4) the Alg. 2 grant loop,
                 alloc_all_kernel (csrc/planner.cu, float64), against its
                 plain version on the card and against the port's numpy
                 VecCluster.alloc_all on 200 seeded random clusters (d = 1 to
                 100 and 1100 rows; N = 1, 2, 4, 8, 16 resident slots; rows
                 past R_MAX; a newcomer that fits nowhere): identical
                 feasibility and grid points, r_inter within rtol 1e-6 /
                 atol 1e-9, and the count of rows bit-identical to numpy;
                 then provision() on the fitted tpu-v5e profiles with
                 PlannerConfig(backend="torch") on the card against
                 backend="numpy" for the 12-workload App study and
                 synthetic_workloads(1000, 0) under both budgets: identical
                 plans, 11 / 6 / 766 / 460 devices, one alloc_all launch per
                 placement (counts read over each provision alone);
                 provision's wall time at m = 1000 for both backends (median
                 of 3, in turns); at that run's final cluster the kernel's
                 and the plain version's device time, and the copies and
                 launches of one whole torch-backend call (torch.profiler)
Prints one {"kernels": [...]} line (the four kernels and alloc_all), one
{"slice": {...}} line per model, one {"planner": {...}} line, and last
{"ok": true, "device": {...}}.
"""
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PORT_TREE = Path(__file__).resolve().parent / "src" / "repro_torch"
sys.path.insert(0, str(PORT_TREE.parent))

# H100 SXM peaks (NVIDIA data sheet): float32 FMA on the CUDA cores, TF32
# on the tensor cores, HBM3 rate.  The fastest float32-accurate route is
# three TF32 passes (3xTF32, as the kernels' tensor-core products run).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_ACCURATE_TC_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {dt: 5 * tol for dt, tol in TOL.items()}  # tests/test_kernels.py: 5x for the scans
RWKV_SHAPE = (4, 512, 32, 64)            # rwkv6-1.6b prefill: B, S, H, hd
SSD_SHAPE = (4, 512, 80, 64, 64)         # zamba2-2.7b prefill: B, S, H, hd, N

BATCH, PROMPT, DECODE, PUMPS = 4, 512, 4, 4
# (arch, layers): every model the port serves, at full width; None = full
# depth.  qwen3-4b runs 12 of its 36 layers to keep the script near 90 s.
MODELS = [("qwen3-4b", 12), ("rwkv6-1.6b", None), ("zamba2-2.7b", None)]
REL_TOL_FULL, REL_TOL_SMALL = 1e-3, 1e-4


T_START = time.perf_counter()


def log(msg):
    """A line of the run's log; results (JSON lines) go through print."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def check_close(name, out, ref, tol):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool((err <= tol + tol * ref.abs()).all())
    max_err = float(err.max())
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {max_err:.3g} over tolerance {tol}")
    return max_err


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def device_kernels_us(prof):
    """(kernel name, device microseconds) for every device kernel a
    torch.profiler run recorded."""
    out = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            out.append((evt.key, evt.self_cuda_time_total if us is None else us))
    return out


def device_ms(fn, n_inputs, iters=20, attempts=6, warmup=3, per_call=None):
    """Mean device time per call of fn(i), cycling over n_inputs input sets:
    the summed durations of the kernels it launched, read with
    torch.profiler, so host time between small launches does not count.
    On an H100 a profiler run that follows a large one drops its first
    kernel records (from 1 of 20 calls to most of them), so each run first keeps the
    card busy for about 10 ms and makes one call, and times only the
    kernels that start inside the "timed" range after them.  Every call
    launches the same kernels: a run whose count of some kernel is no
    multiple of iters lost records there too and is measured again.
    per_call, a dict, receives {kernel name: launches per call}."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            torch.cuda._sleep(20_000_000)        # cycles: about 10 ms
            fn(0)
            torch.cuda.synchronize()
            with torch.profiler.record_function("timed"):
                for i in range(iters):
                    fn(i % n_inputs)
                torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        t0 = next(e.time_range.start for e in events
                  if e.name == "timed" and e.device_type != cuda)
        timed = [e for e in events if e.device_type == cuda and e.name != "timed"
                 and e.time_range.start >= t0]
        counts = {}
        for e in timed:
            counts[e.name] = counts.get(e.name, 0) + 1
        lost = [(name[:60], n) for name, n in counts.items() if n % iters]
        if timed and not lost:
            if per_call is not None:
                per_call.update({name: n // iters for name, n in counts.items()})
            return sum(e.time_range.elapsed_us() for e in timed) / iters / 1e3
        log(f"timing: torch.profiler kept {lost or 'no kernel'} for {iters} calls; "
            "measuring again")
    raise RuntimeError(f"torch.profiler lost device records in {attempts} runs")


def call_device_events(fn, must, attempts=6):
    """Names of the device events (kernels and copies) of one call of fn,
    read with torch.profiler as device_ms reads them: the card kept busy
    first and one call made before the one that counts; measured again
    while the profiler drops records (no event named ``must``)."""
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            torch.cuda._sleep(20_000_000)        # cycles: about 10 ms
            fn()
            torch.cuda.synchronize()
            with torch.profiler.record_function("timed"):
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = next(e.time_range.start for e in events
                  if e.name == "timed" and e.device_type != cuda)
        names = [e.name for e in events if e.device_type == cuda and e.name != "timed"
                 and e.time_range.start >= t0]
        if any(must in name for name in names):
            return names
        log(f"profile: torch.profiler kept {names} of one call; measuring again")
    raise RuntimeError(f"torch.profiler lost device records in {attempts} runs")


def bound(flops, nbytes):
    """The least time the card could take for ``flops`` float32-accurate
    operations and ``nbytes`` of traffic: bound_ms and bound_by at the
    3xTF32 peak, and bound_f32_cores_ms at the CUDA cores' float32 peak
    (the bound of earlier tables)."""
    t_ops, t_bytes = flops / PEAK_F32_ACCURATE_TC_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_f32_cores_ms": max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3}


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_flash(dev, rng):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    cases = [(2, S, H, KV, hd, dt, c, w)
             for S, H, KV, hd in [(128, 4, 4, 64), (256, 8, 2, 64), (256, 4, 1, 128)]
             for dt in (torch.float32, torch.bfloat16)
             for c, w in [(True, None), (False, None), (True, 64)]]
    cases += [(2, 100, 4, 2, hd, dt, True, w) for hd in (32, 128)
              for dt in (torch.float32, torch.bfloat16) for w in (None, 16)]
    cases += [(BATCH, PROMPT + 1, 32, 8, 128, torch.float32, True, None)]
    # zamba2's shared attention: head_dim 80, 32 query and 32 kv heads
    cases += [(2, S, 32, 32, 80, dt, True, None) for S in (100, 256)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(BATCH, PROMPT + 1, 32, 32, 80, torch.float32, True, None)]
    # the edges of the tensor-core tiling (64 query rows a warpgroup, 16 a
    # warp, kv tiles of 32): G = 1, 2, 4, 8 query heads per kv
    # head at every head_dim; S = 1, a block's rows - 1 and + 1, 513; a
    # window of 1 and one longer than S
    dts = (torch.float32, torch.bfloat16)
    cases += [(1, 65, 8, 8 // G, hd, dt, True, None) for hd in (32, 64, 80, 128)
              for G in (1, 2, 4, 8) for dt in dts]
    cases += [(2, S, 4, 2, hd, dt, True, None) for S in (1, 63, 65, 513) for hd in (80, 128)
              for dt in dts]
    cases += [(2, 100, 4, 2, hd, dt, causal, w) for w in (1, 1000) for hd in (64, 80)
              for dt in dts for causal in (True, False)]
    for B, S, H, KV, hd, dt, causal, window in cases:
        q = rand(rng, (B, S, H, hd), dt, dev)
        k, v = rand(rng, (B, S, KV, hd), dt, dev), rand(rng, (B, S, KV, hd), dt, dev)
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        check_close(f"flash {B, S, H, KV, hd, dt, causal, window}", out, want, TOL[dt])
    # the slice's prefill shape: reported as max_abs_err
    B, S, H, KV, hd = BATCH, PROMPT, 32, 8, 128
    q = rand(rng, (B, S, H, hd), torch.float32, dev)
    k, v = rand(rng, (B, S, KV, hd), torch.float32, dev), rand(rng, (B, S, KV, hd), torch.float32, dev)
    err = check_close("flash slice shape", flash_attention(q, k, v),
                      ref.attention_ref(q, k, v), TOL[torch.float32])
    log(f"kernels: flash_attention matches its plain version on {len(cases) + 1} "
        f"cases; slice-shape max_abs_err {err:.3g}")
    x = torch.zeros((1, 64, 2, 96), device=dev)          # head_dim 96: no kernel
    expect_refusal("flash_attention head_dim 96", lambda: flash_attention(x, x, x))
    return err


# what the SASS of every instantiation of a redesigned kernel must hold
# (instantiations: dtype x head_dim, dtype x head_dim x state size in the
# C dispatch): tensor-core products, or asynchronous global -> shared
# copies (LDGSTS is cp.async; UBLKCP / UTMALDG are TMA bulk copies)
TENSOR_CORE = (r"\bHMMA\.\S*TF32|\bHGMMA\.", "tensor-core products (HMMA ... TF32 / HGMMA)")
ASYNC_COPY = (r"\bLDGSTS\b|\bUBLKCP\b|\bUTMALDG\b", "asynchronous copies (LDGSTS / UBLKCP / UTMALDG)")
SASS_CHECKS = {"flash_attn_kernel": (2 * 4, *TENSOR_CORE),
               "ssd_scan_kernel": (2 * 2 * 3, *TENSOR_CORE),
               "rwkv6_scan_kernel": (2 * 2, *TENSOR_CORE),
               "decode_attn_kernel": (2 * 4 * 3, *ASYNC_COPY),   # x G = 1, <= 4, <= 16
               # the planner's grant loop, N = 1 .. 32: float64 arithmetic
               "alloc_all_kernel": (6, r"\bD(ADD|MUL)\b", "float64 arithmetic (DADD / DMUL)")}
GONE_KERNELS = ("decode_attn_combine",)   # decode attention is one launch


def find_cuobjdump():
    """The toolkit's cuobjdump, or the copy Triton ships."""
    found = shutil.which("cuobjdump")
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidates = [found, str(Path(home) / "bin" / "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        candidates.append(str(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError(f"cuobjdump not found in {candidates}")


def check_sass(lib_path):
    """Disassemble the built library (cuobjdump -sass) and require, in every
    instantiation of each kernel of SASS_CHECKS, the instructions it names;
    no kernel of GONE_KERNELS may be left.  Returns {kernel: [matching
    instructions per instantiation]}."""
    sass = subprocess.run([find_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    found = {k: [] for k in SASS_CHECKS}
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        gone = next((k for k in GONE_KERNELS if k in name), None)
        if gone:
            raise AssertionError(f"{name.strip()}: {gone} is still in the library")
        kernel = next((k for k in SASS_CHECKS if k in name), None)
        if kernel is None:
            continue
        n = len(re.findall(SASS_CHECKS[kernel][1], body))
        if n == 0:
            raise AssertionError(f"{name.strip()}: no {SASS_CHECKS[kernel][2]} in its SASS")
        found[kernel].append(n)
    for kernel, (n, _, _) in SASS_CHECKS.items():
        if len(found[kernel]) != n:
            raise AssertionError(f"{kernel}: {len(found[kernel])} instantiations in the SASS, "
                                 f"want {n}")
    return found


def expect_refusal(name, fn):
    """The C interface refuses inputs it has no kernel for; the wrapper
    raises ValueError and counts no launch."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    try:
        fn()
    except ValueError:
        assert ops.launch_counts() == before, name
        return
    raise AssertionError(f"{name}: accepted")


def check_decode(dev, rng):
    from repro_torch.kernels.decode_attention import decode_attention
    dts = (torch.float32, torch.bfloat16)
    n = 0
    # test_kernels.py's grid, a ragged S, one chunk (S=48) and chunks of several tiles (S=2000)
    for S, H, KV, hd in [(512, 4, 2, 64), (1024, 8, 8, 64), (256, 4, 1, 128), (300, 16, 2, 32),
                         (48, 4, 2, 64), (2000, 8, 8, 64), (524, 32, 32, 80)]:
        for dt in dts:
            for window in (None, 128):
                decode_case(dev, rng, 2, S, H, KV, hd, dt, window)
                n += 1
    # the edges of the tiling (32 slots): S = 1, a tile - 1 and + 1; every
    # instantiation (1, 4 and 16 query heads per kv head at every
    # head_dim); a window of 1 and one shorter than a tile
    for dt in dts:
        for S in (1, 63, 65):
            decode_case(dev, rng, 2, S, 8, 2, 128, dt, None)
        for hd in (32, 64, 80, 128):
            for G in (1, 4, 16):
                decode_case(dev, rng, 2, 300, 16, 16 // G, hd, dt, None)
        for window in (1, 20):
            decode_case(dev, rng, 2, 200, 8, 2, 64, dt, window)
        n += 17
    # rolling slots: -1 never written; row 1 has no valid slot -> mean(V)
    B, S, H, KV, hd = 2, 128, 2, 2, 64
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    kvpos = torch.stack([torch.where(ar < 100, ar, -1), torch.full_like(ar, -1)])
    qpos = torch.tensor([99, 99], dtype=torch.int32, device=dev)
    decode_case(dev, rng, B, S, H, KV, hd, torch.float32, None, qpos, kvpos, no_valid_row=1)
    q, kv = torch.zeros((1, 1, 32, 64), device=dev), torch.zeros((1, 64, 1, 64), device=dev)
    pos = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    expect_refusal("decode_attention 32 query heads per kv head",
                   lambda: decode_attention(q, kv, kv, pos[:, 0], pos))
    # the slice's decode shape, the engine's heads-major cache read as a
    # view: only the cluster's last block holds valid slots; a row with no
    # valid slot (mean(V)); in f32 and bf16
    for dt in dts:
        decode_last_block_case(dev, rng, dt)
        decode_slice_case(dev, rng, dt, no_valid_row=True)
        n += 2
    err = decode_slice_case(dev, rng)
    log(f"kernels: decode_attention matches its plain version on {n + 3} cases; "
        f"slice-shape max_abs_err {err:.3g}")
    # one launch of clusters; at the served shapes more blocks than SMs
    from repro_torch.kernels.decode_attention import cluster_room, decode_cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kv_heads = {"qwen3-4b": 8, "zamba2-2.7b": 32}
    split = {arch: decode_cluster(BATCH, kv, PROMPT + DECODE + 8, dev)
             for arch, kv in kv_heads.items()}
    assert all(BATCH * kv_heads[arch] * c >= sms for arch, c in split.items()), (split, sms)
    log(f"kernels: decode clusters per (batch, kv head) {split}; room for clusters of "
        f"1..8 at one block per SM {cluster_room(dev.index or 0)}")
    return err


def decode_case(dev, rng, B, S, H, KV, hd, dt, window, qpos=None, kvpos=None, kv=None,
                q=None, no_valid_row=None, name=""):
    """decode_attention against its plain version; by default positions
    0..S-1 and query positions S // 2 and S - 1.  no_valid_row: a row of
    the batch with no valid slot, which must return mean(V)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    q = rand(rng, (B, 1, H, hd), dt, dev) if q is None else q
    k, v = kv if kv is not None else (rand(rng, (B, S, KV, hd), dt, dev),
                                      rand(rng, (B, S, KV, hd), dt, dev))
    if qpos is None:
        qpos = torch.tensor([S // 2, S - 1] * (B // 2), dtype=torch.int32, device=dev)
    if kvpos is None:
        kvpos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    case = f"decode {name}{B, S, H, KV, hd, dt, window}"
    out = decode_attention(q, k, v, qpos, kvpos, window=window)
    err = check_close(case, out, ref.decode_attention_ref(q, k, v, qpos, kvpos, window=window),
                      TOL[dt])
    if no_valid_row is not None:
        mean_v = v[no_valid_row].float().mean(0).repeat_interleave(H // KV, dim=0)
        check_close(f"{case}: no valid slot = mean(V)", out[no_valid_row, 0], mean_v, TOL[dt])
    return err


def decode_inputs(dev, rng, n_copies=1, H=32, KV=8, hd=128, dt=torch.float32):
    """A served model's decode call, first step after a 512-token prompt:
    q (4, 1, H, hd) and heads-major caches (4, KV, 524, hd) passed as
    (B, S, KV, hd) views; qwen3-4b's heads by default."""
    B, S_buf = BATCH, PROMPT + DECODE + 8
    q = rand(rng, (B, 1, H, hd), dt, dev)
    caches = [(rand(rng, (B, KV, S_buf, hd), dt, dev),
               rand(rng, (B, KV, S_buf, hd), dt, dev)) for _ in range(n_copies)]
    slots = torch.arange(S_buf, dtype=torch.int32, device=dev)[None].expand(B, S_buf)
    kvpos = torch.where(slots < PROMPT + 1, slots, -1)
    qpos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    return q, caches, qpos, kvpos


def decode_slice_case(dev, rng, dt=torch.float32, no_valid_row=False):
    """The slice's decode call; no_valid_row: batch row 1 has no valid slot."""
    q, [(kc, vc)], qpos, kvpos = decode_inputs(dev, rng, dt=dt)
    B, H, KV, hd = q.shape[0], q.shape[2], kc.shape[1], q.shape[3]
    if no_valid_row:
        kvpos = kvpos.clone()
        kvpos[1] = -1
    return decode_case(dev, rng, B, kc.shape[2], H, KV, hd, dt, None, qpos, kvpos,
                       (kc.transpose(1, 2), vc.transpose(1, 2)), q,
                       1 if no_valid_row else None, "slice shape ")


def decode_last_block_case(dev, rng, dt):
    """The slice's decode call where only the slots of the cluster's last
    block are valid (the others never written): every other chunk of the
    split is fully masked and must weigh nothing."""
    from repro_torch.kernels.decode_attention import block_slots, decode_cluster
    q, [(kc, vc)], qpos, kvpos = decode_inputs(dev, rng, dt=dt)
    B, H, KV, hd, S = q.shape[0], q.shape[2], kc.shape[1], q.shape[3], kc.shape[2]
    cluster = decode_cluster(B, KV, S, q.device)
    lo, _ = block_slots(S, cluster, cluster - 1)
    assert cluster > 1 and lo > 0, (cluster, lo)
    kvpos = torch.where(torch.arange(S, device=dev)[None] >= lo, kvpos, -1)
    decode_case(dev, rng, B, S, H, KV, hd, dt, None, qpos, kvpos,
                (kc.transpose(1, 2), vc.transpose(1, 2)), q, name="last block only ")


def rwkv_inputs(rng, B, S, H, hd, dt, dev):
    """r, k, v, logw, u as tests/test_kernels.py draws them (logw clamped)."""
    r, k = 0.5 * rand(rng, (B, S, H, hd), torch.float32, dev), 0.5 * rand(rng, (B, S, H, hd), torch.float32, dev)
    v = rand(rng, (B, S, H, hd), torch.float32, dev)
    logw = torch.clamp(-torch.exp(0.5 * rand(rng, (B, S, H, hd), torch.float32, dev) - 1.5), min=-2.0)
    u = 0.3 * rand(rng, (H, hd), torch.float32, dev)
    return tuple(t.to(dt) for t in (r, k, v, logw, u))


def ssd_inputs(rng, B, S, H, hd, N, dt, dev, group=False):
    """xdt, Bm, Cm, dA as tests/test_kernels.py draws them; group=True
    passes B and C as the Mamba2 block does: (B, S, N) columns of one
    (B, S, H*hd + 2N) buffer, expanded over the heads (head stride 0)."""
    xdt = rand(rng, (B, S, H, hd), dt, dev)
    if group:
        buf = 0.5 * rand(rng, (B, S, H * hd + 2 * N), torch.float32, dev).to(dt)
        Bm = buf[..., H * hd:H * hd + N][:, :, None].expand(B, S, H, N)
        Cm = buf[..., H * hd + N:][:, :, None].expand(B, S, H, N)
    else:
        Bm = (0.5 * rand(rng, (B, S, H, N), torch.float32, dev)).to(dt)
        Cm = (0.5 * rand(rng, (B, S, H, N), torch.float32, dev)).to(dt)
    dA = -torch.exp(0.5 * rand(rng, (B, S, H), torch.float32, dev) - 1.5)
    return xdt, Bm, Cm, dA


def check_scan(name, dev, rng, kernel, plain, make, cases, state_shape, slice_case):
    """One scan kernel against its plain version: the shape grid of
    tests/test_kernels.py, ragged S and nonzero initial states (cases),
    a two-call continuation, and the slice's own shape (max_abs_err)."""
    for shape, dt, with_state in cases:
        args = make(rng, *shape, dt, dev)
        s0 = 0.1 * rand(rng, state_shape(*shape), torch.float32, dev) if with_state else None
        y, s = kernel(*args, s0)
        y_ref, s_ref = plain(*args, s0)
        assert y.dtype == dt and s.dtype == torch.float32, (name, shape, dt)
        check_close(f"{name} y {shape, dt, with_state}", y, y_ref, SCAN_TOL[dt])
        check_close(f"{name} state {shape, dt, with_state}", s, s_ref, SCAN_TOL[dt])
    # continuation: scan(S1) then scan(S2, state) == scan(S1 + S2), the
    # state carried through the initial-state argument
    shape = cases[0][0]
    for dt in (torch.float32, torch.bfloat16):
        args = make(rng, *shape[:1], 357, *shape[2:], dt, dev)
        y_all, s_all = kernel(*args, None)
        first = [t[:, :100] if t.dim() >= 3 else t for t in args]
        rest = [t[:, 100:] if t.dim() >= 3 else t for t in args]
        y1, s1 = kernel(*first, None)
        y2, s2 = kernel(*rest, s1)
        check_close(f"{name} continuation y {dt}", torch.cat([y1, y2], 1), y_all, SCAN_TOL[dt])
        check_close(f"{name} continuation state {dt}", s2, s_all, SCAN_TOL[dt])
    args = make(rng, *slice_case, torch.float32, dev)
    y, s = kernel(*args, None)
    y_ref, s_ref = plain(*args, None)
    err = check_close(f"{name} slice shape", y, y_ref, SCAN_TOL[torch.float32])
    check_close(f"{name} slice-shape state", s, s_ref, SCAN_TOL[torch.float32])
    log(f"kernels: {name} matches its plain version on {len(cases) + 1} cases "
        f"(+ a continuation in f32 and bf16); slice-shape max_abs_err {err:.3g}")
    return err


def check_rwkv(dev, rng):
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    grid = [((2, S, H, hd), dt, False) for S, H, hd in [(128, 2, 32), (256, 4, 64), (64, 2, 32)]
            for dt in (torch.float32, torch.bfloat16)]
    ragged = [((2, S, 2, 64), dt, False) for S in (100, 513) for dt in (torch.float32, torch.bfloat16)]
    state = [((2, S, 2, hd), dt, True) for S, hd in [(64, 32), (513, 64)]
             for dt in (torch.float32, torch.bfloat16)]
    # the edges of the two-stage copy and its zero-fill (chunks of 32): S =
    # 1, one step short of a chunk and one past it, at both head_dims; the
    # ragged S = 33 from an initial state
    edges = [((2, S, 2, hd), dt, False) for S in (1, 31, 33) for hd in (32, 64)
             for dt in (torch.float32, torch.bfloat16)]
    edges += [((2, 33, 2, hd), dt, True) for hd in (32, 64)
              for dt in (torch.float32, torch.bfloat16)]
    err = check_scan("rwkv6_scan", dev, rng,
                     lambda r, k, v, w, u, s0: rwkv6_scan(r, k, v, w, u, s0=s0),
                     ref.rwkv6_ref, rwkv_inputs, grid + ragged + state + edges,
                     lambda B, S, H, hd: (B, H, hd, hd), RWKV_SHAPE)
    x = torch.zeros((1, 32, 1, 128), device=dev)       # head_dim 128: no kernel
    expect_refusal("rwkv6_scan head_dim 128",
                   lambda: rwkv6_scan(x, x, x, x, torch.zeros((1, 128), device=dev)))
    return err


def check_ssd(dev, rng):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    grid = [((2, S, H, hd, N), dt, False) for S, H, hd, N in [(128, 2, 32, 16), (256, 4, 64, 64)]
            for dt in (torch.float32, torch.bfloat16)]
    ragged = [((2, S, 2, 64, 64), dt, False) for S in (100, 513)
              for dt in (torch.float32, torch.bfloat16)]
    state = [((2, S, 2, hd, N), dt, True) for S, hd, N in [(128, 32, 16), (513, 64, 64)]
             for dt in (torch.float32, torch.bfloat16)]
    # the edges of the tensor-core tiling (chunks of 64 in a ring of two,
    # 32 state rows a block): S = 1, S below a chunk, S = 2048 (32 chunks
    # of state carried across), and every (hd, N) the dispatch takes
    edges = [((2, S, 2, 64, 64), dt, S != 1) for S in (1, 40, 2048)
             for dt in (torch.float32, torch.bfloat16)]
    edges += [((2, 100, 2, hd, N), dt, True) for hd, N in [(32, 32), (32, 64), (64, 16), (64, 32)]
              for dt in (torch.float32, torch.bfloat16)]
    err = check_scan("ssd_scan", dev, rng,
                     lambda x, b, c, a, h0: ssd_scan(x, b, c, a, h0=h0),
                     ref.ssd_ref,
                     # per-head B/C on the grid's lengths, group form (head stride 0) on the others
                     lambda rng, B, S, *rest: ssd_inputs(rng, B, S, *rest, group=S not in (128, 256)),
                     grid + ragged + state + edges,
                     lambda B, S, H, hd, N: (B, H, hd, N), SSD_SHAPE)
    x = torch.zeros((1, 8, 1, 64), device=dev)         # state size 128: no kernel
    bc = torch.zeros((1, 8, 1, 128), device=dev)
    expect_refusal("ssd_scan state size 128",
                   lambda: ssd_scan(x, bc, bc, torch.zeros((1, 8, 1), device=dev)))
    return err


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def want_launches(cfg):
    """Launches of each kernel over the timed pumps: every prefill runs
    flash attention once per attention block and a scan once per recurrent
    block; every decode step after the first token runs decode attention
    once per attention block."""
    kind = cfg.pattern[0]
    n_attn = cfg.n_layers if kind == "attn" else (
        cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0)
    return {"flash_attention": n_attn * PUMPS,
            "decode_attention": n_attn * (DECODE - 1) * PUMPS,
            "rwkv6_scan": cfg.n_layers * PUMPS if kind == "rwkv6" else 0,
            "ssd_scan": cfg.n_layers * PUMPS if kind == "mamba2" else 0,
            "alloc_all": 0}


def run_slice(dev, arch, layers=None):
    """Serve ``arch`` at full width (``layers``: cut depth) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=BATCH, prompt_len=PROMPT,
                        decode_tokens=DECODE, seed=0, device=dev)
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"slice: {arch} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params f32, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card); "
        f"init + warm-up {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=PROMPT).astype(np.int32)
               for _ in range(BATCH * PUMPS)]
    done = []
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    for p in range(PUMPS):
        for i in range(BATCH):
            rid = p * BATCH + i
            eng.submit(Request(rid=rid, tokens=prompts[rid], arrival_s=time.time()))
        done += eng.pump()
    wall = time.perf_counter() - t_start
    launches = ops.launch_counts()

    assert len(done) == BATCH * PUMPS, len(done)
    for c in done:
        assert c.tokens.shape == (DECODE,), c.tokens.shape
        assert ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all(), c.tokens
    want = want_launches(cfg)
    assert launches == want, (launches, want)
    log(f"slice: {arch}: {len(done)} completions in {PUMPS} pumps, launches {launches}")

    # consistency at full width: decode step 1 == prefill over prompt + token
    model, params = eng.model, eng.params
    toks = torch.from_numpy(np.stack(prompts[:BATCH])).to(dev)
    buf = PROMPT + DECODE + 8
    with torch.inference_mode():
        cache = model.init_cache(BATCH, buf, dtype=torch.float32)
        lg0, cache = model.prefill(params, {"tokens": toks}, cache)
        tok = lg0.argmax(-1).to(torch.int32)[:, None]
        lg1, _ = model.decode_step(params, tok, cache)
        full, _ = model.prefill(params, {"tokens": torch.cat([toks, tok], 1)},
                                model.init_cache(BATCH, buf, dtype=torch.float32))
        # the same prompt from the used cache, without and with reset_cache
        stale, _ = model.prefill(params, {"tokens": toks}, cache)
        again, _ = model.prefill(params, {"tokens": toks}, model.reset_cache(cache))
    assert torch.equal(again, lg0), "a reset cache differs from a fresh one"
    stale_rel = rel_err(stale, lg0)
    log(f"slice: {arch}: a reset cache gives a fresh cache's logits bit for bit "
        f"(the used cache unreset: rel. err {stale_rel:.3g})")
    for name, t in (("prefill", lg0), ("decode", lg1), ("prefill+1", full)):
        assert t.shape[-1] == cfg.vocab_size and bool(torch.isfinite(t).all()), name
    assert np.array_equal(tok[:, 0].cpu().numpy(), np.stack([c.tokens[0] for c in done[:BATCH]])), \
        "engine's first tokens differ from the model's own prefill"
    rel = rel_err(lg1[:, 0], full)
    log(f"slice: {arch}: decode-vs-prefill rel. err {rel:.3g} (limit {REL_TOL_FULL})")
    assert rel <= REL_TOL_FULL, rel

    # one prefill and one decode step alone, host clock around a synchronize
    with torch.inference_mode():
        cache = model.init_cache(BATCH, buf, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg0, cache = model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()

    lats = np.array([c.latency_ms for c in done])
    stats = {"arch": arch, "layers": cfg.n_layers, "batch": BATCH, "prompt_len": PROMPT,
             "decode_tokens": DECODE, "requests": len(done), "launches": launches,
             "p50_ms": float(np.percentile(lats, 50)),
             "p99_ms": float(np.percentile(lats, 99)),
             "tokens_per_s": len(done) * DECODE / wall,
             "prefill_ms": (t1 - t0) * 1e3, "decode_step_ms": (t2 - t1) * 1e3,
             "decode_vs_prefill_rel_err": rel, "unreset_cache_rel_err": stale_rel,
             "alone": profile_alone(model, params, cfg, toks, tok, buf)}
    # a pump of the first pump's prompts again: the engine's cache, reset,
    # must give the same tokens (a state left from the last pass would not)
    stats["profile"], again = profile_pump(eng, prompts[:BATCH], wall * 1e3 / PUMPS)
    assert all(np.array_equal(a.tokens, c.tokens) for a, c in zip(again, done[:BATCH])), \
        "a repeated pump gave other tokens"
    log(f"slice: {arch}: a repeated pump returns the first pump's tokens")
    del eng, model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


KERNEL_GROUPS = {"flash_attn_kernel": "flash_attention", "decode_attn": "decode_attention",
                 "rwkv6_scan_kernel": "rwkv6_scan", "ssd_scan_kernel": "ssd_scan"}


def kernel_groups(prof):
    """Device ms by kernel group in one torch.profiler run."""
    groups = dict.fromkeys([*KERNEL_GROUPS.values(), "matmul", "other"], 0.0)
    for key, us in device_kernels_us(prof):
        name = key.lower()
        group = next((g for k, g in KERNEL_GROUPS.items() if k in name), None)
        if group:
            groups[group] += us / 1e3
        elif "gemm" in name or "gemv" in name or "cutlass" in name:
            groups["matmul"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    if sum(groups.values()) <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return groups


def aten_calls(prof):
    """ATen operator calls the host issued in one torch.profiler run,
    nested calls included."""
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


def prefill_matmul_flops(cfg, batch, seq):
    """Operations of the prefill's matrix products, from the shapes: every
    projection of every block (attention QKV/O and SwiGLU; RWKV6 r, k, v,
    g, o, its low-rank mixes and channel mix; Mamba2 in/out projections),
    zamba2's shared block once per group, and the head on the last token."""
    from repro_torch.models import rwkv, ssm
    T, d, hd, kind = batch * seq, cfg.d_model, cfg.hd, cfg.pattern[0]
    attn = (2 * T * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + 2 * T * cfg.n_heads * hd * d + 3 * 2 * T * d * cfg.d_ff)
    if kind == "attn":
        per_layer = attn
    elif kind == "rwkv6":
        per_layer = 2 * T * (6 * d * d + 2 * d * cfg.d_ff
                             + 2 * 5 * rwkv.LORA_R * d + 2 * rwkv.DECAY_R * d)
    else:
        d_in, H, G, N, _ = ssm._dims(cfg)
        per_layer = 2 * T * (d * (2 * d_in + 2 * G * N + H) + d_in * d)
    groups = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    return cfg.n_layers * per_layer + groups * attn + 2 * batch * d * cfg.vocab_size


def profile_alone(model, params, cfg, toks, tok, buf):
    """One prefill and then one decode step, each alone under
    torch.profiler: device ms by group, the prefill's matmul rate, and the
    host's ATen calls per layer of the decode step."""
    with torch.inference_mode():
        cache = model.init_cache(BATCH, buf, dtype=torch.float32)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            model.prefill(params, {"tokens": toks}, cache)
            torch.cuda.synchronize()
        prefill = kernel_groups(prof)
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
        decode = kernel_groups(prof)
        decode_aten = aten_calls(prof)
    flops = prefill_matmul_flops(cfg, BATCH, PROMPT)
    return {"prefill_device_ms": prefill,
            "prefill_matmul_tflop": flops / 1e12,
            "prefill_matmul_tflop_per_s": flops / (prefill["matmul"] * 1e-3) / 1e12,
            "decode_step_device_ms": decode,
            "decode_step_aten_calls_per_layer": decode_aten / cfg.n_layers}


def profile_pump(eng, prompts, pump_ms):
    """Device time by kernel group over one more pump (torch.profiler), and
    the share of an unprofiled pump's wall time (pump_ms, the mean of the
    timed pumps) in which no kernel ran; also the pump's completions."""
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=1000 + i, tokens=p, arrival_s=time.time()))
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        done = eng.pump()
    groups = kernel_groups(prof)
    return {"pump_ms": pump_ms, "device_ms": groups,
            "idle_share": max(0.0, 1.0 - sum(groups.values()) / pump_ms)}, done


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check_small_against_cpu(dev, arch):
    """A reduced ``arch`` on the card against the same weights on the CPU
    (plain path): logits of prefill and three decode steps.  zamba2 keeps
    two groups (4 layers)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    cfg = get_config(arch)
    cfg = reduced(cfg, layers=4 if cfg.shared_attn_every else 2)
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, dev)
    params_cpu = cpu_model.init(seed=1)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    worst = 0.0
    with torch.inference_mode():
        cc = cpu_model.init_cache(2, 32, dtype=torch.float32)
        gc_ = gpu_model.init_cache(2, 32, dtype=torch.float32)
        lc, cc = cpu_model.prefill(params_cpu, {"tokens": tokens}, cc)
        lg, gc_ = gpu_model.prefill(params_gpu, {"tokens": tokens.to(dev)}, gc_)
        worst = max(worst, rel_err(lg.cpu(), lc))
        for _ in range(3):
            tok = lc.reshape(2, -1).argmax(-1).to(torch.int32)[:, None]
            lc, cc = cpu_model.decode_step(params_cpu, tok, cc)
            lg, gc_ = gpu_model.decode_step(params_gpu, tok.to(dev), gc_)
            worst = max(worst, rel_err(lg.cpu(), lc))
    log(f"small: reduced {arch} on the card vs CPU, worst rel. err {worst:.3g} "
        f"(limit {REL_TOL_SMALL})")
    assert worst <= REL_TOL_SMALL, worst
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Phase 5: timing at the slice's shapes
# ---------------------------------------------------------------------------

def time_flash(dev, rng, err, H=32, KV=8, hd=128):
    """Flash attention at a served model's prefill shape (qwen3-4b's heads
    by default): kernel, plain version and SDPA device times, and bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, S = BATCH, PROMPT
    q = rand(rng, (B, S, H, hd), torch.float32, dev)
    k, v = rand(rng, (B, S, KV, hd), torch.float32, dev), rand(rng, (B, S, KV, hd), torch.float32, dev)
    # the yardstick: SDPA's efficient kernel on K/V expanded to H heads
    # outside the timed call (with enable_gqa, f32 SDPA runs only its math
    # backend); that math-backend time is kept beside it where H > KV
    qt, kg, vg = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous() for t in (k, v))
    with torch.inference_mode():
        ms = device_ms(lambda i: flash_attention(q, k, v), 1)
        plain_ms = device_ms(lambda i: ref.attention_ref(q, k, v), 1, iters=5)
        lib = library_times(
            lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 1),
            None if H == KV else lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kg, vg, is_causal=True, enable_gqa=True), 1))
    pairs = S * (S + 1) // 2                      # causal (q, k) pairs per head
    flops = 4 * hd * pairs * B * H                # QK^T and PV, 2 flops per FMA
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes), **lib}


def time_decode(dev, rng, err, H=32, KV=8, hd=128):
    """Decode attention at a served model's first decode step (qwen3-4b's
    heads by default), over enough cache copies to exceed the L2 cache."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    n_copies = 8                                  # 8 x 17 MB of cache > 50 MB L2
    q, caches, qpos, kvpos = decode_inputs(dev, rng, n_copies, H, KV, hd)
    views = [(kc.transpose(1, 2), vc.transpose(1, 2)) for kc, vc in caches]
    B, S_buf = q.shape[0], caches[0][0].shape[2]
    mask = (kvpos >= 0) & (kvpos <= qpos[:, None])
    qh = q.transpose(1, 2)                        # (B, H, 1, hd)
    expanded = [tuple(c.repeat_interleave(H // KV, dim=1) for c in kv) for kv in caches]
    with torch.inference_mode():
        per_call = {}
        ms = device_ms(lambda i: decode_attention(q, *views[i], qpos, kvpos), n_copies, 40,
                       per_call=per_call)
        assert list(per_call.values()) == [1] and "decode_attn_kernel" in next(iter(per_call)), \
            f"decode_attention: one kernel launch per call, got {per_call}"
        plain_ms = device_ms(lambda i: ref.decode_attention_ref(q, *views[i], qpos, kvpos),
                           n_copies, 16)
        lib = library_times(
            lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qh, *expanded[i], attn_mask=mask[:, None, None, :]), n_copies, 40),
            None if H == KV else lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qh, caches[i][0], caches[i][1], attn_mask=mask[:, None, None, :],
                enable_gqa=True), n_copies, 40))
    del expanded
    valid = int(mask.sum())                       # valid (b, slot) pairs
    flops = 4 * hd * H * valid
    nbytes = 4 * (2 * B * KV * S_buf * hd + B * S_buf + B + 2 * B * H * hd)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:64",
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes), **lib}


SDPA_EFFICIENT = "scaled_dot_product_attention, EFFICIENT_ATTENTION backend, K/V expanded to H heads"


def library_times(efficient, gqa_math=None):
    """The attention rows' yardstick: ``efficient()`` timed under SDPA's
    efficient backend, named, not guessed; ``gqa_math()`` (enable_gqa on
    float32, which only the math backend takes) as library_math_ms, the
    time earlier tables gave, where the two calls differ."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = {"library_ms": efficient(), "library": SDPA_EFFICIENT}
    if gqa_math is not None:
        with sdpa_kernel(SDPBackend.MATH):
            out["library_math_ms"] = gqa_math()
    return out


def time_rwkv(dev, rng, err):
    """rwkv6_scan at rwkv6-1.6b's prefill, from a zero initial state as the
    model passes it; no single PyTorch call computes the recurrence."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    B, S, H, hd = RWKV_SHAPE
    r, k, v, logw, u = rwkv_inputs(rng, B, S, H, hd, torch.float32, dev)
    s0 = torch.zeros((B, H, hd, hd), device=dev)
    with torch.inference_mode():
        ms = device_ms(lambda i: rwkv6_scan(r, k, v, logw, u, s0=s0), 1)
        # thousands of small kernels a call: the profiler's own cost grows with them
        plain_ms = device_ms(lambda i: ref.rwkv6_ref(r, k, v, logw, u, s0), 1, iters=1, warmup=1)
    # the recurrence's least work per step and head: the state's read-out
    # r·S and its rank-1 update kᵀv, 2 flops per FMA (a chunked form decays
    # the state once a chunk, so the per-step decay is left out)
    flops = B * S * H * 4 * hd * hd
    nbytes = 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:60",
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
            "library_ms": None}


def time_ssd(dev, rng, err):
    """ssd_scan at zamba2-2.7b's prefill: B and C in group form expanded
    over the heads and a zero initial state, as the Mamba2 block passes
    them; no single PyTorch call computes the recurrence."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    B, S, H, hd, N = SSD_SHAPE
    xdt, Bm, Cm, dA = ssd_inputs(rng, B, S, H, hd, N, torch.float32, dev, group=True)
    h0 = torch.zeros((B, H, hd, N), device=dev)
    with torch.inference_mode():
        ms = device_ms(lambda i: ssd_scan(xdt, Bm, Cm, dA, h0=h0), 1)
        plain_ms = device_ms(lambda i: ref.ssd_ref(xdt, Bm, Cm, dA, h0), 1, iters=1, warmup=1)
    # as for rwkv6: the read-out C·S and the rank-1 update xdtᵀB per step and
    # head, 2 flops per FMA
    flops = B * S * H * 4 * hd * N
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * N + B * S * H + 2 * B * H * hd * N)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:55",
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
            "library_ms": None}


def log_timing(k, what=None):
    lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
    if "library_math_ms" in k:
        lib += f" (math backend {k['library_math_ms']:.4f})"
    log(f"timing: {what or k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
        f"library {lib}, bound {k['bound_ms']:.4f} by {k['bound_by']}, "
        f"on the CUDA cores {k['bound_f32_cores_ms']:.4f}); "
        f"plain / kernel = {k['plain_ms'] / k['ms']:.2f}, "
        f"{k['bound_ms'] / k['ms']:.1%} of bound")


# ---------------------------------------------------------------------------
# Phase 6: the planner (Alg. 1/2 behind PlannerConfig(backend="torch"))
# ---------------------------------------------------------------------------

PLANNER_TOL = dict(rtol=1e-6, atol=1e-9)   # the reference's JAX contract
PEAK_F64_FLOPS = 34e12                      # H100 SXM float64, CUDA cores (data sheet)
PLANNER_CLUSTERS = 200
# devices the numpy oracle opens for (m, budget) on the fitted tpu-v5e profiles
PLANNER_DEVICES = {(12, "queueing"): 11, (12, "half"): 6,
                   (1000, "queueing"): 766, (1000, "half"): 460}


def random_planner_coeffs(rng):
    """tests/test_perf_model_vec.py's random_coeffs over
    tests/test_perf_model.py's make_coeffs, with the port's types."""
    from repro_torch.core.types import WorkloadCoefficients
    k1, k2, k3 = rng.uniform(0.001, 0.03), rng.uniform(0.2, 6.0), rng.uniform(0.5, 9.0)
    k4, k5, alpha_cache = rng.uniform(0.01, 0.5), rng.uniform(0.01, 0.5), rng.uniform(0.0, 0.6)
    return WorkloadCoefficients(
        model="m", hardware="hw", d_load=0.5, d_feedback=0.01, n_kernels=400, k_sch=0.005,
        k1=k1, k2=k2, k3=k3, k4=k4, k5=k5, alpha_power=500.0, beta_power=5.0,
        alpha_cacheutil=1.2, beta_cacheutil=0.02, alpha_cache=alpha_cache)


def random_planner_workload(rng, name, theorem1):
    """A random spec and coefficients; the batch and r from Theorem 1
    (appropriate_batch, resource_lower_bound) when ``theorem1``, else drawn
    as tests/test_perf_model_vec.py's random_device draws them (batch
    1..32, r in [0.05, 1)).  None when Theorem 1 finds it infeasible."""
    from repro_torch.core import provisioner as prov
    from repro_torch.core.types import V5E, WorkloadSpec
    spec = WorkloadSpec(name, "m", float(rng.uniform(60.0, 400.0)),
                        float(rng.uniform(5.0, 80.0)))
    c = random_planner_coeffs(rng)
    if not theorem1:
        return spec, c, int(rng.integers(1, 33)), float(rng.uniform(0.05, 1.0))
    try:
        b = prov.appropriate_batch(spec, c, V5E)
        return spec, c, b, prov.resource_lower_bound(spec, c, V5E, b)
    except prov.InfeasibleError:
        return None


def planner_cases(rng):
    """PLANNER_CLUSTERS random numpy-backend VecClusters and their newcomers:
    d = 1 to 100 and one of 1100 rows; N = 1, 2, 4, 8 and 16 resident
    slots; residents and newcomers sized by Theorem 1, and in every fourth
    cluster drawn raw (rows past R_MAX from the start); one newcomer that
    fits nowhere (r_lower 0.975 against raw residents)."""
    from repro_torch.core import perf_model_vec as pmv
    from repro_torch.core.types import V5E
    for i in range(PLANNER_CLUSTERS):
        budget = ("queueing", "half")[i % 2]
        if i == 0:
            d, max_res, cap_n = 1100, 6, 4
        elif i % 10 == 9:
            d, max_res, cap_n = 1 + i % 3, 2, 1           # N = 1 or 2
        elif i % 10 == 7:
            d, max_res, cap_n = 8, 12, 4                  # N = 16
        else:
            d, max_res, cap_n = (1, 3, 8, 32, 100)[i % 5], (4, 6)[i % 2], 4
        raw = i % 4 == 3 or i == 5
        cl = pmv.VecCluster(V5E, cap_n=cap_n, budget=budget)
        for q in range(d):
            cl.add_device()
            for j in range(int(rng.integers(1, max_res + 1))):
                w = random_planner_workload(rng, f"R{q}_{j}", not raw)
                if w is not None:
                    cl.add_entry(q, *w)
        new = None
        while new is None:
            new = random_planner_workload(rng, "NEW", True)
        if i == 5:
            new = new[:3] + (0.975,)
        yield cl, new


def check_planner(dev, rng):
    """alloc_all_kernel against its plain version on the card and against
    the port's numpy VecCluster.alloc_all: identical feasibility, identical
    grid points on every feasible row, r_inter within PLANNER_TOL; counts
    the rows whose every output is bit-identical to numpy's."""
    from repro_torch.core import perf_model_torch as pmt
    from repro_torch.kernels import grant_loop
    stats = {"clusters": 0, "rows": 0, "rows_feasible": 0, "rows_bit_identical_kernel": 0,
             "rows_bit_identical_plain": 0, "fits_nowhere": 0, "N": set(), "max_d": 0}
    err = 0.0
    for cl, new in planner_cases(rng):
        d, n = cl.d, cl.mask.shape[1]
        want = cl.alloc_all(*new)
        packed = torch.from_numpy(pmt.pack(cl, *new)).to(dev)
        outs = {"kernel": grant_loop.alloc_all(packed, d, n),
                "plain": grant_loop.alloc_all_plain(packed, d, n)}
        fa = want[0]
        for name, out in outs.items():
            got = grant_loop.split_out(out.cpu().numpy(), d, n)
            np.testing.assert_array_equal(got[0], fa, err_msg=f"{name}: feasibility")
            np.testing.assert_array_equal(got[1][fa], want[1][fa], err_msg=f"{name}: rr")
            np.testing.assert_array_equal(got[2][fa], want[2][fa], err_msg=f"{name}: rn")
            np.testing.assert_allclose(got[3][fa], want[3][fa], err_msg=f"{name}: r_inter",
                                       **PLANNER_TOL)
            assert np.isinf(got[3][~fa]).all(), f"{name}: r_inter of infeasible rows"
            same = ((got[1] == want[1]).all(axis=1) & (got[2] == want[2])
                    & (got[3] == want[3]))
            stats[f"rows_bit_identical_{name}"] += int(same.sum())
        diff = (outs["kernel"] - outs["plain"]).abs()
        err = max(err, float(diff[torch.isfinite(diff)].max()))
        stats["clusters"] += 1
        stats["rows"] += d
        stats["rows_feasible"] += int(fa.sum())
        stats["fits_nowhere"] += int(not fa.any())
        stats["N"].add(n)
        stats["max_d"] = max(stats["max_d"], d)
    stats["N"] = sorted(stats["N"])
    assert stats["fits_nowhere"] >= 1 and stats["max_d"] >= 1024 and 8 in stats["N"], stats
    assert 0 < stats["rows_feasible"] < stats["rows"], stats
    log(f"planner: alloc_all_kernel and its plain version match numpy on "
        f"{stats['clusters']} clusters ({stats['rows']} rows, {stats['rows_feasible']} "
        f"feasible, N {stats['N']}, d up to {stats['max_d']}, {stats['fits_nowhere']} "
        f"newcomer(s) fitting nowhere); bit-identical rows: kernel "
        f"{stats['rows_bit_identical_kernel']}, plain {stats['rows_bit_identical_plain']}; "
        f"kernel vs plain max_abs_err {err:.3g}")
    return stats, err


def planner_breakdown(provision):
    """Where provision's time goes at m = 1000 (queueing budget): the wall
    seconds inside VecCluster.alloc_all for each backend (host clock, one
    unprofiled run each), and, over one profiled torch-backend run, the
    device ms of the grant-loop kernels and of the copies, and the share
    of that run's wall time in which the card was idle."""
    from repro_torch.core import perf_model_vec as pmv
    alloc_all = pmv.VecCluster.alloc_all
    spent = {"numpy": 0.0, "torch": 0.0}

    def timed(self, *args):
        t0 = time.perf_counter()
        try:
            return alloc_all(self, *args)
        finally:
            spent[self.backend] += time.perf_counter() - t0

    out = {}
    pmv.VecCluster.alloc_all = timed
    try:
        for backend in spent:
            _, wall = provision(1000, "queueing", backend)
            out[backend] = {"wall_s": wall, "alloc_all_s": spent[backend],
                            "alloc_all_share": spent[backend] / wall}
    finally:
        pmv.VecCluster.alloc_all = alloc_all
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _, wall = provision(1000, "queueing", "torch")
    groups = {"alloc_all_kernel": 0.0, "memcpy_htod": 0.0, "memcpy_dtoh": 0.0, "other": 0.0}
    kernels = 0
    for key, us in device_kernels_us(prof):
        group = ("alloc_all_kernel" if "alloc_all_kernel" in key else "memcpy_htod"
                 if "HtoD" in key else "memcpy_dtoh" if "DtoH" in key else "other")
        groups[group] += us / 1e3
    for evt in prof.key_averages():
        if "alloc_all_kernel" in evt.key and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += evt.count
    out["torch_profiled"] = {"wall_s": wall, "device_ms": groups,
                             "alloc_all_kernels_recorded": kernels,
                             "idle_share": max(0.0, 1.0 - sum(groups.values()) / (wall * 1e3))}
    log(f"planner: breakdown at m=1000: {out}")
    return out


def run_planner(dev):
    """provision() through PlannerConfig(backend="torch") on the card
    against backend="numpy": the 12-workload App study and
    synthetic_workloads(1000, 0) on the fitted tpu-v5e profiles, under both
    budgets; identical plans, the oracle's device counts, one kernel launch
    per placement.  Then provision's wall time at m = 1000 (queueing
    budget) for both backends, median of 3 in turns, and the grant loop at
    the final cluster of that run: kernel and plain device time, copies and
    launches per call, and the bound."""
    from repro_torch.core import perf_model_torch as pmt
    from repro_torch.core import provisioner as prov
    from repro_torch.core.fitted import fitted_context
    from repro_torch.core.types import PlannerConfig
    from repro_torch.kernels import grant_loop, ops
    from repro_torch.serving.workload import synthetic_workloads, twelve_workloads
    ctx = fitted_context("tpu-v5e")
    workloads = {12: twelve_workloads(), 1000: synthetic_workloads(1000, 0)}

    def key(plan):
        return ([(p.workload.name, p.gpu, round(p.r, 9), p.batch)
                 for p in plan.placements], plan.n_gpus)

    def provision(m, budget, backend):
        cfg = PlannerConfig(backend=backend, budget=budget,
                            device=str(dev) if backend == "torch" else None)
        t0 = time.perf_counter()
        plan = prov.provision(workloads[m], ctx.profiles, ctx.hw, config=cfg)
        if backend == "torch":
            torch.cuda.synchronize()
        return plan, time.perf_counter() - t0

    # record the cluster and the newcomer of the last grant-loop call
    last = {}
    alloc_all_torch = pmt.alloc_all_torch

    def recording(cl, *args):
        last["cl"], last["args"] = cl, args
        return alloc_all_torch(cl, *args)

    plans, refs, launches_m1000 = [], {}, None
    for m, budget in PLANNER_DEVICES:
        ref, _ = provision(m, budget, "numpy")
        refs[(m, budget)] = key(ref)
        pmt.alloc_all_torch = recording if (m, budget) == (1000, "queueing") else alloc_all_torch
        ops.reset_launch_counts()
        try:
            plan, _ = provision(m, budget, "torch")
        finally:
            pmt.alloc_all_torch = alloc_all_torch
        launches = ops.launch_counts()
        assert key(plan) == key(ref), f"m={m} {budget}: torch and numpy plans differ"
        assert plan.n_gpus == PLANNER_DEVICES[(m, budget)], (m, budget, plan.n_gpus)
        want = {k: (m if k == "alloc_all" else 0) for k in launches}
        assert launches == want, (m, budget, launches)
        if (m, budget) == (1000, "queueing"):
            launches_m1000 = launches["alloc_all"]
        plans.append({"m": m, "budget": budget, "devices": plan.n_gpus, "identical": True,
                      "alloc_all_launches": launches["alloc_all"]})
        log(f"planner: m={m} {budget}: {plan.n_gpus} devices, plans identical, "
            f"{launches['alloc_all']} alloc_all launches")

    walls = {"torch": [], "numpy": []}
    for _ in range(3):
        for backend in walls:
            plan, wall = provision(1000, "queueing", backend)
            assert key(plan) == refs[(1000, "queueing")], backend
            walls[backend].append(wall)
    wall_median = {b: float(np.median(w)) for b, w in walls.items()}
    log(f"planner: provision at m=1000 (queueing), wall s torch {walls['torch']} "
        f"numpy {walls['numpy']}; medians {wall_median}")
    breakdown = planner_breakdown(provision)

    cl, args = last["cl"], last["args"]
    d, n = cl.d, cl.mask.shape[1]
    packed = torch.from_numpy(pmt.pack(cl, *args)).to(dev)
    per_call = {}
    ms = device_ms(lambda i: grant_loop.alloc_all(packed, d, n), 1, iters=20, per_call=per_call)
    assert list(per_call.values()) == [1] and "alloc_all_kernel" in next(iter(per_call)), \
        f"alloc_all: one kernel launch per call, got {per_call}"
    # thousands of small kernels a call: the profiler's own cost grows with them
    plain_ms = device_ms(lambda i: grant_loop.alloc_all_plain(packed, d, n), 1, iters=1,
                         warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = grant_loop.alloc_all_plain(packed, d, n)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    # the whole torch path of one call: pack, copies, kernel, read-back
    names = call_device_events(lambda: pmt.alloc_all_torch(cl, *args), "alloc_all_kernel")
    copies = {"htod": sum("HtoD" in x for x in names), "dtoh": sum("DtoH" in x for x in names),
              "kernels": sum("alloc_all_kernel" in x for x in names)}
    assert copies["htod"] + copies["dtoh"] == pmt.COPIES_PER_CALL and copies["kernels"] == 1, \
        f"alloc_all_torch: {pmt.COPIES_PER_CALL} copies and one launch per call, got {names}"

    # the least work: each input read once, each output written once; and
    # per row at least 1 + its most grants iterations of the eval, plus the grants
    nbytes = 8 * (grant_loop.pack_size(d, n) + grant_loop.out_size(d, n))
    _, planes, rows = grant_loop.unpack(packed.cpu(), d, n)
    feasible, rr, rn, _ = grant_loop.split_out(out.cpu().numpy(), d, n)
    r_unit, r_lower = ctx.hw.r_unit, args[3]
    mask = planes["mask"].numpy() != 0
    grants = np.where(mask, np.rint((rr - planes["r"].numpy()) / r_unit), 0)
    grants_new = np.rint((rn - r_lower) / r_unit)
    iters = 1 + np.maximum(grants.max(axis=1), grants_new)
    flops = float((iters * (15 * n + 17)).sum() + 22 * (grants.sum() + grants_new.sum()))
    t_ops, t_bytes = flops / PEAK_F64_FLOPS, nbytes / PEAK_BYTES_S
    entry = {"name": "alloc_all", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/planner.cu",
             "replaces": "src/repro/core/perf_model_jax.py:177",
             "launches": launches_m1000, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}
    stats = {"plans": plans, "provision_wall_s_m1000": walls,
             "provision_wall_s_m1000_median": wall_median, "breakdown_m1000": breakdown,
             "final_cluster": {"d": d, "n": n, "feasible_rows": int(feasible.sum()),
                               "row_iterations_lower_bound": int(iters.sum())},
             "alloc_all_kernel_ms": ms, "alloc_all_plain_ms": plain_ms,
             "alloc_all_plain_wall_ms": plain_wall_ms, "per_call": copies,
             "bytes_per_call": nbytes, "flops_lower_bound": flops,
             "bound_bytes_ms": t_bytes * 1e3, "bound_ops_ms": t_ops * 1e3}
    log(f"timing: alloc_all {ms:.4f} ms at the final cluster (d {d}, N {n}; plain "
        f"{plain_ms:.4f} device ms, {plain_wall_ms:.1f} wall ms; bound {entry['bound_ms']:.6f} "
        f"by {entry['bound_by']}: {nbytes} bytes, {flops:.0f} float64 operations); "
        f"per call {copies}")
    return entry, stats


def main():
    if not PORT_TREE.is_dir():
        print(f"chip_smoke: {PORT_TREE} is missing: this script drives the port "
              "in src/repro_torch and runs from a checkout of the repository",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    t_all = time.perf_counter()
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    _build.load()
    log(f"build: {_build.build_seconds:.1f} s -> {_build.library_path().name}")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off in torch"
    # the disassembly runs on the host while phase 3 runs on the card
    with ThreadPoolExecutor(1) as pool:
        sass = pool.submit(check_sass, _build.library_path())
        rng = np.random.default_rng(0)
        errs = {"flash_attention": check_flash(dev, rng),
                "decode_attention": check_decode(dev, rng),
                "rwkv6_scan": check_rwkv(dev, rng), "ssd_scan": check_ssd(dev, rng)}
        for kernel, counts in sass.result().items():
            log(f"sass: every {kernel} instantiation holds {SASS_CHECKS[kernel][2]}: "
                f"{counts}")
    # phase 5 before phase 4: the larger the profiler runs before a timing,
    # the more kernel records it drops (see device_ms)
    kernels = []
    for name, timer in (("flash_attention", time_flash), ("decode_attention", time_decode),
                        ("rwkv6_scan", time_rwkv), ("ssd_scan", time_ssd)):
        kernels.append(timer(dev, rng, errs[name]))
        log_timing(kernels[-1])
    # the attention kernels at zamba2-2.7b's shared block: head_dim 80, 32 kv heads
    hd80 = [time_flash(dev, rng, errs["flash_attention"], 32, 32, 80),
            time_decode(dev, rng, errs["decode_attention"], 32, 32, 80)]
    for k in hd80:
        log_timing(k, f"{k['name']} (zamba2-2.7b, head_dim 80)")
    # phase 6, the planner, before the pumps' large profiler runs as well
    clusters, planner_err = check_planner(dev, np.random.default_rng(17))
    planner_kernel, planner = run_planner(dev)
    planner_kernel["max_abs_err"] = planner_err
    launches, slices = dict.fromkeys(errs, 0), []
    for arch, layers in MODELS:
        check_small_against_cpu(dev, arch)
        counts, stats = run_slice(dev, arch, layers)
        launches = {k: n + counts[k] for k, n in launches.items()}
        slices.append(stats)
    kernels = [{**k, "launches": launches[k["name"]]} for k in kernels] + [planner_kernel]
    zamba = next(st for st in slices if st["arch"] == "zamba2-2.7b")
    zamba["attention_hd80"] = {k["name"]: {key: k[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_f32_cores_ms")}
        for k in hd80}
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    for stats in slices:
        print(json.dumps({"slice": {**stats, "gpu": smi}}), flush=True)
    print(json.dumps({"planner": {"random_clusters": clusters, **planner, "gpu": smi}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
