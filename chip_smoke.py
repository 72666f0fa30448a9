#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in the order they run; any failure raises and exits non-zero.  The
function that makes a check describes it.
  1. device     -- the card's name and power limit (nvidia-smi).
  2. build      -- nvcc builds kernels/csrc into one library; ptxas's registers
                   and spills; every kernel's SASS holds its instructions (check_sass).
  3. kernels    -- each CUDA kernel against its plain version on the card, at
                   the test grid's, the served models' and the cells' shapes.
     cells      -- one served pass of every workload in BENCHMARK.json, built by
                   perfbench's own readers (check_cell_pass); check_gemm follows.
  5. timing     -- each kernel's device time beside its plain version, a
                   library call and its bound (time_*; time_gemm after phase 8).
  6. planner    -- alloc_all_kernel and provision() on the card against numpy.
  7. simulator  -- tables_kernel and simulate_full on the card against numpy.
  8. controller -- the closed loop's scenarios on the card against numpy.
  4. slices     -- eleven served models at full width (depth cut: MODELS) against
                   the CPU and against themselves (run_slice); checks, no timing.
  9. training   -- the kernels' autograd wrappers and three models' training.
 10. mesh       -- the dry runs, and the steps on a one-card DeviceMesh.
Prints JSON lines: {"kernels": [...]}, then {"cell": {...}} for each cell and
{"slice": {...}} for each model, then {"planner": ...}, {"simulator": ...},
{"controller": ...}, {"train": ...}, {"mesh": ...} and last
{"ok": true, "device": {...}}.
"""
import collections
import contextlib
import dataclasses
import functools
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
BENCH_TREE = PORT_TREE.parents[1] / "perfbench"
sys.path.insert(0, str(PORT_TREE.parent))

# H100 SXM peaks (NVIDIA data sheet): float32 FMA on the CUDA cores, TF32
# on the tensor cores, HBM3 rate.  The fastest float32-accurate route is
# three TF32 passes (3xTF32, as the kernels' tensor-core products run).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_ACCURATE_TC_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the partial decode against its plain version: both take the cache's
# values to float32 and compute in float32, in either input dtype
PARTIAL_O_TOL = 2e-5                     # its float32 output
PARTIAL_LSE_TOL = 1e-5                   # its log-sum-exp, absolute
SCAN_TOL = {dt: 5 * tol for dt, tol in TOL.items()}  # tests/test_kernels.py: 5x for the scans
RWKV_SHAPE = (4, 512, 32, 64)            # rwkv6-1.6b prefill: B, S, H, hd
SSD_SHAPE = (4, 512, 80, 64, 64)         # zamba2-2.7b prefill: B, S, H, hd, N
# products a pass of each BENCHMARK.json cell through the 3xTF32 kernel, and
# left to cuBLAS by the shape rule (rwkv6's rank-64 decay LoRA, granite's
# 72-wide router); a cell added to the benchmark adds its entry here
GEMM_CELL_PASS = {"qwen15-4b.w6-closed": (280, 0), "rwkv6-1.6b.w5-closed": (216, 48),
                  "granite4-h-small.w6x4-closed": (208, 40),
                  "deepseek-v2-lite.w6-closed": (189, 26)}

BATCH, PROMPT, DECODE, PUMPS = 4, 512, 4, 4
# (arch, layers, encoder layers): every model the port serves, at full
# width; None = full depth.  Depth is cut to keep the script near 200 s
# before phase 9 (training) was added: the dense models (qwen3-4b among
# them) and qwen2-vl-7b run 8 layers, whisper-large-v3 8 of its 32 decoder
# and 8 of its 32 encoder layers, the MoE models 2 (9.66 and 12.68 GB of
# float32 experts a layer); zamba2-2.7b 18 of its 54 (3 shared-attention
# groups), cut when phase 9 added about 80 s; deepseek-v2-lite 2 of its 27
# (the dense layer and one MoE layer of 64 experts, 2.2 GB).
MODELS = [("qwen3-4b", 8, None), ("rwkv6-1.6b", None, None), ("zamba2-2.7b", 18, None),
          ("yi-6b", 8, None), ("qwen1.5-4b", 8, None), ("minitron-4b", 8, None),
          ("mixtral-8x22b", 2, None), ("dbrx-132b", 2, None),
          ("qwen2-vl-7b", 8, None), ("whisper-large-v3", 8, 8), ("deepseek-v2-lite", 2, None)]
# decode grids that cannot fill the card: 4 x 4 (batch, kv head) pairs in
# clusters of at most 8 blocks (logged, not asserted)
SMALL_DECODE_GRID = ("yi-6b", "qwen2-vl-7b")
REL_TOL_FULL, REL_TOL_SMALL = 1e-3, 1e-4


T_START = time.perf_counter()


def log(msg):
    """A line of the run's log; results (JSON lines) go through print."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def model_configs():
    """{arch: config} of every model in MODELS, from the port's registry."""
    from repro_torch.configs import get_config
    return {arch: get_config(arch) for arch, _, _ in MODELS}


def served_attention():
    """{arch: config} of the served models whose blocks are all GQA
    attention: head_dim 128, but whisper-large-v3's 64.  deepseek-v2-lite's
    latent attention (q.k 192, v 128; no decode kernel) is timed apart."""
    cfgs = {arch: c for arch, c in model_configs().items()
            if set(c.pattern) == {"attn"} and not c.mla}
    assert all(c.hd == (64 if c.family == "encdec" else 128) for c in cfgs.values()), \
        {a: c.hd for a, c in cfgs.items()}
    assert {c.hd for c in cfgs.values()} == {64, 128}, {a: c.hd for a, c in cfgs.items()}
    return cfgs


def encdec_shapes():
    """(B, frames, heads, kv heads, head_dim) of each served encoder-decoder
    model: its encoder's self-attention and its cross-attention."""
    return sorted({(BATCH, c.encoder_seq_len, c.n_heads, c.n_kv_heads, c.hd)
                   for c in served_attention().values() if c.encoder_layers})


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


def device_groups(prof, wall, kernels):
    """One profiled run of ``wall`` seconds: the device ms of each of
    ``kernels`` (by name), of the host-to-device and device-to-host copies
    and of the rest; each kernel's records; and the share of the wall time
    in which the card was idle.  A dropped record would hide device time:
    the idle share is an upper bound then, and the records say by how
    much."""
    groups = dict.fromkeys([*kernels, "memcpy_htod", "memcpy_dtoh", "other"], 0.0)
    for key, us in device_kernels_us(prof):
        group = next((k for k in kernels if k in key),
                     "memcpy_htod" if "HtoD" in key else "memcpy_dtoh" if "DtoH" in key
                     else "other")
        groups[group] += us / 1e3
    recorded = {k: sum(e.count for e in prof.key_averages()
                       if k in e.key and e.device_type == torch.autograd.DeviceType.CUDA)
                for k in kernels}
    return {"wall_s": wall, "device_ms": groups, "kernels_recorded": recorded,
            "idle_share": max(0.0, 1.0 - sum(groups.values()) / (wall * 1e3))}


def device_ms(fn, n_inputs, iters=20, attempts=6, warmup=3, per_call=None):
    """Mean device time per call of fn(i), cycling over n_inputs input sets:
    the summed durations of the kernels it launched, read with
    torch.profiler, so host time between small launches does not count.
    On an H100 a profiler run that follows a large one drops its first
    kernel records (from 1 of 20 calls to most of them), so each run first keeps the
    card busy for about 10 ms and makes one call, and times only the
    kernels that start inside the "timed" range after them.  Every call
    launches the same kernels: a run whose count of some kernel is no
    multiple of iters lost records there too and is measured again; if
    every run loses some, the last run's kept records give each kernel's
    mean (while each kept at least half its calls).
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
    if timed and all(2 * n >= iters for n in counts.values()):
        # every run lost a few records (on some hosts the first of 20 calls
        # each time): each kernel's kept records give its mean duration,
        # and its launches a call are the nearest whole number
        per = {name: round(n / iters) for name, n in counts.items()}
        log(f"timing: records lost in all {attempts} runs; each kernel's mean over the "
            f"records kept ({counts}) times its launches a call {per}")
        if per_call is not None:
            per_call.update(per)
        return sum(per[e.name] * e.time_range.elapsed_us() / counts[e.name]
                   for e in timed) / 1e3
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

def check_flash(dev, rng, cells):
    """flash_attention against its plain version in f32 and bf16
    (TOL): the test grid, head_dim 80, the tensor-core tiling's edges (S =
    1, 63, 65, 513; windows of 1 and longer than S; 1 to 8 query heads a kv
    head), every served model's heads at its head_dim, a kv length of
    its own (S = 1, 63, 512 against Skv = 1, 31, 33, 1500, whisper's encoder
    and cross shapes), and latent attention's q.k 192 / V 128 as each such
    cell of ``cells`` (benchmark_cells) hands it over; inputs with no kernel
    refused.  Returns the slice shape's max_abs_err."""
    from repro_torch.kernels import ops, ref
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
    # the served attention models' heads at their head_dim (128, whisper's
    # 64): at the main path's prompt shape with the model's window, at a
    # ragged prompt, and mixtral's heads under a window shorter than the
    # prompt
    heads = sorted({(c.n_heads, c.n_kv_heads, c.sliding_window, c.hd)
                    for c in served_attention().values()}, key=str)
    served = [(B, S, H, KV, hd, dt, True, w) for H, KV, w, hd in heads
              for B, S in ((BATCH, PROMPT), (2, PROMPT + 1)) for dt in dts]
    served += [(2, PROMPT + 1, H, KV, hd, dt, True, 64) for H, KV, w, hd in heads if w
               for dt in dts]
    cases += served
    cases = [(B, S, S, H, KV, hd, dt, causal, window)
             for B, S, H, KV, hd, dt, causal, window in cases]
    # a kv length of its own (no mask): the q tile's rows and the kv tiles'
    # edges (S = 1, 63, 512 against Skv = 1, 31, 33, 1500) at both head_dims,
    # and whisper's encoder (1500 frames) and cross-attention (a prompt
    # against 1500 frames) at the served shape
    kv_cases = [(2, S, Skv, 4, 2, hd, dt, False, None) for S in (1, 63, PROMPT)
                for Skv in (1, 31, 33, 1500) for hd in (64, 128) for dt in dts]
    for B, Se, H, KV, hd in encdec_shapes():
        kv_cases += [(B, S, Se, H, KV, hd, dt, False, None) for S in (Se, PROMPT) for dt in dts]
    cases += kv_cases
    for B, S, Skv, H, KV, hd, dt, causal, window in cases:
        q = rand(rng, (B, S, H, hd), dt, dev)
        k, v = rand(rng, (B, Skv, KV, hd), dt, dev), rand(rng, (B, Skv, KV, hd), dt, dev)
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        check_close(f"flash {B, S, Skv, H, KV, hd, dt, causal, window}", out, want, TOL[dt])
    # the slice's prefill shape: reported as max_abs_err
    B, S, H, KV, hd = BATCH, PROMPT, 32, 8, 128
    q = rand(rng, (B, S, H, hd), torch.float32, dev)
    k, v = rand(rng, (B, S, KV, hd), torch.float32, dev), rand(rng, (B, S, KV, hd), torch.float32, dev)
    err = check_close("flash slice shape", flash_attention(q, k, v),
                      ref.attention_ref(q, k, v), TOL[torch.float32])
    # latent attention (MLA) at q.k 192 / V 128 as an MLA cell's prefill
    # hands it over: the cell's batch and heads, K contiguous, V the strided
    # half kv[..., 128:] of W_kvb's (k_nope | v) product; at the cell's
    # prompt and the tiling's edges, S = 1, 63, 65, 513
    mla = [(cell.traffic["batch_size"], S, c.n_heads, c.qk_nope_head_dim, c.hd, c.v_head_dim,
            dt) for cell, c in cells.values() if c.mla
           for S in (cell.traffic["prompt_len"], 1, 63, 65, 513) for dt in dts]
    mla_before = ops.launch_counts()["flash_attention_mla"]
    for B, S, H, n, hd, hdv, dt in mla:
        q, k = rand(rng, (B, S, H, hd), dt, dev), rand(rng, (B, S, H, hd), dt, dev)
        v = rand(rng, (B, S, H, n + hdv), dt, dev)[..., n:]
        check_close(f"flash MLA {B, S, H, hd, hdv, dt}", flash_attention(q, k, v),
                    ref.attention_ref(q, k, v), TOL[dt])
    assert ops.launch_counts()["flash_attention_mla"] - mla_before == len(mla)
    log(f"kernels: flash_attention matches its plain version on {len(cases) + 1 + len(mla)} "
        f"cases ({len(served)} at the served group sizes G = "
        f"{sorted({H // KV for H, KV, _, _ in heads})} and head_dims "
        f"{sorted({hd for _, _, _, hd in heads})}, {len(kv_cases)} at a kv length of "
        f"their own, {len(mla)} at the MLA cells' q.k 192 / V 128 with a strided V); "
        f"slice-shape max_abs_err {err:.3g}")
    x = torch.zeros((1, 64, 2, 96), device=dev)          # head_dim 96: no kernel
    expect_refusal("flash_attention head_dim 96", lambda: flash_attention(x, x, x))
    q, v = torch.zeros((1, 64, 2, 192), device=dev), torch.zeros((1, 64, 2, 96), device=dev)
    expect_refusal("flash_attention q.k 192 / V 96", lambda: flash_attention(q, q, v))
    q, kv = torch.zeros((1, 64, 2, 64), device=dev), torch.zeros((1, 96, 2, 64), device=dev)
    expect_refusal("flash_attention causal at a kv length of its own",
                   lambda: flash_attention(q, kv, kv, causal=True))
    expect_refusal("flash_attention windowed at a kv length of its own",
                   lambda: flash_attention(q, kv, kv, causal=False, window=16))
    return err


# what the SASS of every instantiation of a redesigned kernel must hold
# (instantiations: dtype x head_dim, dtype x head_dim x state size in the
# C dispatch): tensor-core products, or asynchronous global -> shared
# copies (LDGSTS is cp.async; UBLKCP / UTMALDG are TMA bulk copies)
TENSOR_CORE = (r"\bHMMA\.\S*TF32|\bHGMMA\.", "tensor-core products (HMMA ... TF32 / HGMMA)")
ASYNC_COPY = (r"\bLDGSTS\b|\bUBLKCP\b|\bUTMALDG\b", "asynchronous copies (LDGSTS / UBLKCP / UTMALDG)")
# flash: x hd 32, 64, 80, 128 and latent attention's q.k 192 / v 128
SASS_CHECKS = {"flash_attn_kernel": (2 * 5, *TENSOR_CORE),
               # x hd 32, 64 x N 16, 32, 64, and N 128 at hd 64
               "ssd_scan_kernel": (2 * (2 * 3 + 1), *TENSOR_CORE),
               # gate and up, down
               "moe_gemm_kernel": (2, r"\bHGMMA\.", "wgmma products (HGMMA)"),
               "dense_gemm_kernel": (1, *TENSOR_CORE),   # layers.mm's float32 products
               "rwkv6_scan_kernel": (2 * 2, *TENSOR_CORE),
               # x G = 1, <= 4, <= 16, x served / partial
               "decode_attn_kernel": (2 * 4 * 3 * 2, *ASYNC_COPY),
               # the planner's grant loop, N = 1 .. 32: float64 arithmetic
               "alloc_all_kernel": (6, r"\bD(ADD|MUL)\b", "float64 arithmetic (DADD / DMUL)")}
# a second requirement of a kernel's every instantiation
SASS_ALSO = {"moe_gemm_kernel": (r"\bUTMALDG\b", "TMA tile loads (UTMALDG)")}
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
    instantiation of each kernel of SASS_CHECKS, the instructions it names
    (and those SASS_ALSO names);
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
        if kernel in SASS_ALSO and not re.search(SASS_ALSO[kernel][0], body):
            raise AssertionError(f"{name.strip()}: no {SASS_ALSO[kernel][1]} in its SASS")
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
    """decode_attention against its plain version in f32 and bf16: the
    test grid, a ragged S, one chunk and many, the tiling's edges at every
    instantiation, windows of 1 and 20, rolling slots with a row that has
    no valid slot, the served shape with valid slots only in the cluster's
    last block, every served model's first decode step and whisper's cross
    cache; then the partial variant (check_decode_partial); the served
    grids fill the card (but SMALL_DECODE_GRID's, logged).
    Returns the served shape's max_abs_err."""
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
    # the served models' query heads per kv head at their head_dim (G = 1,
    # 3, 4, 6, 7, 8 at 128; whisper's G = 1 at 64), at their first decode
    # step's cache (mixtral's is rolling: the same slots); whisper's cross
    # cache, (B, frames, KV, hd) as the model keeps it, with q at the last
    # frame's position so that every frame is visible
    served = 0
    for H, KV, hd in sorted({(c.n_heads, c.n_kv_heads, c.hd)
                             for c in served_attention().values()}):
        for dt in dts:
            q, [(kc, vc)], qpos, kvpos = decode_inputs(dev, rng, H=H, KV=KV, hd=hd, dt=dt)
            decode_case(dev, rng, BATCH, kc.shape[2], H, KV, hd, dt, None, qpos, kvpos,
                        (kc.transpose(1, 2), vc.transpose(1, 2)), q, name="served ")
            served += 1
    for B, Se, H, KV, hd in encdec_shapes():
        for dt in dts:
            decode_cross_case(dev, rng, B, Se, H, KV, hd, dt)
            served += 1
    err = decode_slice_case(dev, rng)
    log(f"kernels: decode_attention matches its plain version on {n + served + 3} cases "
        f"({served} at the served group sizes and cross caches); slice-shape max_abs_err "
        f"{err:.3g}")
    check_decode_partial(dev, rng)
    # one launch of clusters; at the served shapes more blocks than SMs, but
    # for SMALL_DECODE_GRID: 4 x 4 (batch, kv head) pairs in clusters of at most 8
    from repro_torch.kernels.decode_attention import cluster_room, decode_cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = {arch: (c.n_kv_heads, PROMPT + DECODE + 8) for arch, c in model_configs().items()
             if ("attn" in c.pattern or c.shared_attn_every) and not c.mla}
    grids.update({f"{arch} cross": (c.n_kv_heads, c.encoder_seq_len)
                  for arch, c in model_configs().items() if c.encoder_layers})
    split = {name: decode_cluster(BATCH, kv, slots, dev) for name, (kv, slots) in grids.items()}
    blocks = {name: BATCH * grids[name][0] * c for name, c in split.items()}
    assert all(n >= sms for name, n in blocks.items() if name not in SMALL_DECODE_GRID), \
        (split, sms)
    small = {name: f"{blocks[name]} blocks, {blocks[name] / sms:.3f} a SM"
             for name in SMALL_DECODE_GRID}
    log(f"kernels: decode clusters per (batch, kv head) {split}; grids that cannot fill "
        f"the card {small}; room for clusters of 1..8 at one block per SM "
        f"{cluster_room(dev.index or 0)}")
    return err


def partial_case(dev, rng, B, S, H, KV, hd, dt, window, qpos=None, kvpos=None, name=""):
    """decode_attention_partial against its plain version on a heads-major
    cache (B, KV, S, hd) read as a view: o (float32) within PARTIAL_O_TOL
    in either input dtype, lse within PARTIAL_LSE_TOL where the plain version's is finite and NEG_INF
    exactly where it is NEG_INF.  Positions as decode_case's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_partial
    q = rand(rng, (B, 1, H, hd), dt, dev)
    k, v = (rand(rng, (B, KV, S, hd), dt, dev).transpose(1, 2) for _ in range(2))
    if qpos is None:
        qpos = torch.tensor([S // 2, S - 1] * (B // 2), dtype=torch.int32, device=dev)
    if kvpos is None:
        kvpos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    case = f"decode partial {name}{B, S, H, KV, hd, dt, window}"
    o, lse = decode_attention_partial(q, k, v, qpos, kvpos, window=window)
    want_o, want_lse = ref.decode_attention_partial_ref(q, k, v, qpos, kvpos, window=window)
    assert o.dtype == lse.dtype == torch.float32, (case, o.dtype, lse.dtype)
    err = check_close(case, o, want_o, PARTIAL_O_TOL)
    empty = want_lse == ref.NEG_INF
    assert torch.equal(lse == ref.NEG_INF, empty), f"{case}: lse NEG_INF elsewhere"
    lse_err = float((lse - want_lse)[~empty].abs().max()) if bool((~empty).any()) else 0.0
    assert lse_err <= PARTIAL_LSE_TOL, f"{case}: lse max_abs_err {lse_err:.3g}"
    return err, lse_err, int(empty.sum())


def check_decode_partial(dev, rng):
    """The partial variant (the decode step on a cache sharded over its
    slots) against its plain version: every instantiation (f32 and bf16,
    head_dim 32/64/80/128, 1, 4 and 16 query heads per kv head), a window,
    a ragged S, the served shape with a row with no valid slot, and
    decode_32k's local shard with only its first slots valid."""
    n, errs, lse_errs, empties = 0, [], [], 0
    for dt in (torch.float32, torch.bfloat16):
        for hd in (32, 64, 80, 128):
            for G in (1, 4, 16):
                e, le, _ = partial_case(dev, rng, 2, 300, 16, 16 // G, hd, dt, None)
                errs.append(e)
                lse_errs.append(le)
                n += 1
        for S, window in ((65, None), (200, 20)):
            e, le, _ = partial_case(dev, rng, 2, S, 8, 2, 64, dt, window)
            errs.append(e)
            lse_errs.append(le)
            n += 1
        S = PROMPT + DECODE + 8
        kvpos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(BATCH, 1)
        kvpos[1] = -1
        e, le, k = partial_case(dev, rng, BATCH, S, 32, 8, 128, dt, None,
                                torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev),
                                kvpos, "served, row 1 empty ")
        assert k == 32, k                     # row 1's heads
        # decode_32k's shard: 2048 slots of 32768, a sequence early in the cache
        e2, le2, k2 = partial_case(dev, rng, 8, 2048, 32, 8, 128, dt, None,
                                   torch.tensor([5, 40] * 4, dtype=torch.int32, device=dev),
                                   torch.arange(2048, dtype=torch.int32,
                                                device=dev)[None].expand(8, 2048),
                                   "decode_32k shard ")
        errs += [e, e2]
        lse_errs += [le, le2]
        empties += k + k2
        n += 2
    log(f"kernels: decode_attention_partial matches its plain version on {n} cases: o "
        f"max_abs_err {max(errs):.3g}, lse {max(lse_errs):.3g} where finite, NEG_INF on "
        f"{empties} (row, head)s with no valid slot")


SEGMENT_SHAPES = ((BATCH, PROMPT + DECODE + 8, torch.float32),     # qwen3-4b's served cache
                  (BATCH, PROMPT + DECODE + 8, torch.bfloat16),
                  (8, 2048, torch.bfloat16))                        # decode_32k's local shard


def decode_segments(dev, rng):
    """The decode step's path on a cache sharded over its slots, on one
    card: the partial kernel on 2, 4 and 8 slot segments of a heads-major
    cache (qwen3-4b's heads, SEGMENT_SHAPES), joined by combine_partials as
    the ranks are joined, against the whole-cache kernel (TOL of the
    cache's dtype).  Query positions leave the last segment without a
    valid slot in rows 0 and 2, and row 3 has none at all.  The launch
    counts are set to 0 before each split and read after it: one partial
    launch a segment, none of the served kernel (a check's launches: the
    kernels line counts phase 10's decode steps).  Returns max_abs_err."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (combine_partials, decode_attention,
                                                      decode_attention_partial)
    from repro_torch.kernels.ref import NEG_INF
    H, KV, hd = 32, 8, 128
    worst, launches = 0.0, 0
    for B, S, dt in SEGMENT_SHAPES:
        q = rand(rng, (B, 1, H, hd), dt, dev)
        kc, vc = (rand(rng, (B, KV, S, hd), dt, dev) for _ in range(2))
        kvpos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        kvpos[3] = -1
        qpos = torch.tensor([S // 2 - 1, S - 1] * (B // 2), dtype=torch.int32, device=dev)
        whole = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), qpos, kvpos)
        for n in (2, 4, 8):
            cuts = [i * S // n for i in range(n + 1)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            parts = [decode_attention_partial(q, kc[:, :, a:b].transpose(1, 2),
                                              vc[:, :, a:b].transpose(1, 2), qpos,
                                              kvpos[:, a:b]) for a, b in zip(cuts, cuts[1:])]
            o, lse = (torch.stack(x) for x in zip(*parts))
            got = combine_partials(o, lse, [b - a for a, b in zip(cuts, cuts[1:])])
            torch.cuda.synchronize()
            counts = {k: c for k, c in ops.launch_counts().items() if c}
            assert counts == {"decode_attention_partial": n}, counts
            launches += n
            assert bool((lse[-1, 0] == NEG_INF).all()) and bool((lse[:, 3] == NEG_INF).all())
            worst = max(worst, check_close(f"decode segments {B, S, dt} in {n}", got, whole,
                                           TOL[dt]))
    log(f"kernels: decode over 2, 4, 8 slot segments (partial kernel + combine_partials) "
        f"equals the whole-cache kernel at {[s[:2] for s in SEGMENT_SHAPES]}: max_abs_err "
        f"{worst:.3g}; {launches} partial launches, none of the served kernel")
    return worst


def decode_cross_case(dev, rng, B, Se, H, KV, hd, dt):
    """decode_attention on an encoder-decoder model's cross cache: slots
    0..Se-1, q at position Se - 1 (every frame visible)."""
    kvpos = torch.arange(Se, dtype=torch.int32, device=dev)[None].expand(B, Se)
    qpos = torch.full((B,), Se - 1, dtype=torch.int32, device=dev)
    return decode_case(dev, rng, B, Se, H, KV, hd, dt, None, qpos, kvpos, name="cross cache ")


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
    """rwkv6_scan against its plain version (check_scan): the test grid, a
    ragged S, initial states, the chunk's edges (S = 1, 31, 33) at head_dim
    32 and 64; head_dim 128 refused."""
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
    """ssd_scan against its plain version (check_scan): the test grid, a
    ragged S, initial states, S = 1, 40 and 2048, every (hd, N) the
    dispatch takes, B and C in group form; N = 128 at head_dim 32 refused."""
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
    edges += [((2, 100, 2, hd, N), dt, True)
              for hd, N in [(32, 32), (32, 64), (64, 16), (64, 32), (64, 128)]
              for dt in (torch.float32, torch.bfloat16)]
    err = check_scan("ssd_scan", dev, rng,
                     lambda x, b, c, a, h0: ssd_scan(x, b, c, a, h0=h0),
                     ref.ssd_ref,
                     # per-head B/C on the grid's lengths, group form (head stride 0) on the others
                     lambda rng, B, S, *rest: ssd_inputs(rng, B, S, *rest, group=S not in (128, 256)),
                     grid + ragged + state + edges,
                     lambda B, S, H, hd, N: (B, H, hd, N), SSD_SHAPE)
    x = torch.zeros((1, 8, 1, 32), device=dev)         # state size 128 at hd 32: no kernel
    bc = torch.zeros((1, 8, 1, 128), device=dev)
    expect_refusal("ssd_scan state size 128 at head_dim 32",
                   lambda: ssd_scan(x, bc, bc, torch.zeros((1, 8, 1), device=dev)))
    return err


def check_ssd_cell(dev, rng, shape):
    """ssd_scan at a cell's prefill ``shape`` (B, S, H, hd, N), B and C in
    group form, from a state: max_abs_err."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    B, S, H, hd, N = shape
    xdt, Bm, Cm, dA = ssd_inputs(rng, B, S, H, hd, N, torch.float32, dev, group=True)
    h0 = 0.1 * rand(rng, (B, H, hd, N), torch.float32, dev)
    y, h = ssd_scan(xdt, Bm, Cm, dA, h0=h0)
    y_ref, h_ref = ref.ssd_ref(xdt, Bm, Cm, dA, h0)
    err = check_close(f"ssd_scan {shape}", y, y_ref, SCAN_TOL[torch.float32])
    check_close(f"ssd_scan state {shape}", h, h_ref, SCAN_TOL[torch.float32])
    log(f"kernels: ssd_scan at a cell's prefill {shape} matches its plain version; "
        f"max_abs_err {err:.3g}")
    return err


def moe_inputs(rng, T, D, F, E, held, K, dev, one_expert=False):
    """The grouped products' inputs as the dropless layer hands them over:
    tokens routed over E experts (every token's first choice expert 1 with
    ``one_expert``), sorted by expert, and the held experts' weights at
    fan-in scale."""
    from repro_torch.models import moe
    x = rand(rng, (T, D), torch.float32, dev)
    router = rand(rng, (D, E), torch.float32, dev) / D ** 0.5
    if one_expert:
        x = x.abs()
        router[:, 1] = 1.0
    w = [rand(rng, shape, torch.float32, dev) / shape[1] ** 0.5
         for shape in ((held, D, F), (held, D, F), (held, F, D))]
    tok, gates, offsets, pos = moe.route_sorted(router, x, K, held)
    return x, tok, offsets, gates, pos, *w


# Edges of the grouped products' token tile (moe_gemm.TILE_ROWS, 48 rows):
# (T, K, E, held, the held experts' rows), the other assignments on experts
# held .. E - 1.  Each case has an expert of a whole number of tiles, one of
# a row more and an empty one; the second and fourth most assignments past
# offsets[held], the fourth most held experts empty; the third and sixth
# experts of several tiles; the fifth every assignment on a held expert.
MOE_EDGES = ((64, 2, 8, 4, (48, 49, 0, 7)), (120, 2, 16, 8, (49, 0, 48, 1, 0, 0, 0, 0)),
             (200, 2, 8, 4, (97, 0, 96, 40)), (100, 2, 24, 20, (48, 0, 49) + (0,) * 17),
             (97, 1, 4, 3, (48, 49, 0)), (145, 3, 12, 6, (144, 145, 0, 48, 0, 1)))


def moe_edge_inputs(rng, T, K, E, held, rows, D, F, dev):
    """The grouped products' inputs with held expert e taking rows[e] tokens
    (the tokens with the most free slots, the lower first) and each token's
    other slots on distinct experts past the held ones, sorted as
    route_sorted sorts; weights at fan-in scale."""
    ids = np.full((T, K), -1)
    for e, n in enumerate(rows):
        free = (ids < 0).sum(1)
        chosen = sorted(range(T), key=lambda t: (-free[t], t))[:n]
        assert all(free[t] for t in chosen), (T, K, rows)
        for t in chosen:
            ids[t, np.argmax(ids[t] < 0)] = e
    for t in range(T):
        for k in np.flatnonzero(ids[t] < 0):
            ids[t, k] = held + (t + k) % (E - held)
    assert all((ids == e).sum() == n for e, n in enumerate(rows))
    ids = torch.from_numpy(ids)
    key, perm = torch.sort(torch.where(ids < held, ids, held).reshape(-1), stable=True)
    offsets = torch.searchsorted(key, torch.arange(held + 1))
    pos = torch.empty_like(perm).scatter_(0, perm, torch.arange(T * K)).view(T, K)
    gates = torch.from_numpy(rng.uniform(0.1, 1.0, T * K).astype(np.float32))[perm]
    w = [rand(rng, shape, torch.float32, dev) / shape[1] ** 0.5
         for shape in ((held, D, F), (held, D, F), (held, F, D))]
    return (rand(rng, (T, D), torch.float32, dev), (perm // K).to(dev), offsets.to(dev),
            gates.to(dev), pos.to(dev), *w)


def check_moe(dev, rng, shape):
    """The grouped expert products against their plain version: a cell's
    ``shape`` (T, D, F, E, held, K), there also with every token on one
    expert (its rows = T, none dropped), a ragged small case and one token;
    then the token tile's edges, MOE_EDGES.  Each case within TOL[float32] of ref.moe_experts_ref, one
    launch counted a call, and a second call on the same inputs equal bit
    for bit.  Returns the cell shape's max_abs_err."""
    from repro_torch.kernels import moe_gemm, ops, ref
    cases = [(f"{shape} one expert {one}", moe_inputs(rng, *shape, dev, one_expert=one))
             for one in (False, True)]
    cases += [(str(c), moe_inputs(rng, *c, dev)) for c in ((100, 256, 128, 8, 5, 3),
                                                            (1, 128, 64, 4, 4, 2))]
    cases += [(f"tile edges {edge}", moe_edge_inputs(rng, *edge, 256, 192, dev))
              for edge in MOE_EDGES]
    errs = []
    with torch.inference_mode():
        for name, args in cases:
            before = ops.launch_counts()["moe_experts"]
            y = ops.moe_experts(*args)
            again = ops.moe_experts(*args)
            assert ops.launch_counts()["moe_experts"] == before + 2, name
            assert torch.equal(y, again), f"moe_experts {name}: two calls differ"
            errs.append(check_close(f"moe_experts {name}", y, ref.moe_experts_ref(*args),
                                    TOL[torch.float32]))
        rows = (cases[1][1][2][1:] - cases[1][1][2][:-1]).tolist()
        assert rows[1] == shape[0], rows
    log(f"kernels: moe_experts matches its plain version on {len(cases)} cases (the "
        f"{moe_gemm.TILE_ROWS}-row tile at its edges), each call repeated bit for bit; "
        f"max_abs_err {[f'{e:.3g}' for e in errs]}")
    return errs[0]


def gemm_operands(rng, T, K, N, dev):
    """x (T, K) standard normal and w (K, N) at fan-in scale."""
    return rand(rng, (T, K), torch.float32, dev), rand(rng, (K, N), torch.float32, dev) / K ** 0.5


def rel_to_f64(y, x, w):
    """max |y - x w| over max |x w|, the product taken in float64."""
    y64 = x.double() @ w.double()
    return ((y.double() - y64).abs().max() / y64.abs().max()).item()


def check_gemm(dev, rng, passes):
    """The 3xTF32 product kernel against its plain version (at the plan's
    split of K): ragged T, K and N, splits 1 to 8, T below 64, and every
    shape the cells' ``passes`` (check_cell_pass) sent it; two calls bit for
    bit equal, one launch a call; K not a multiple of 4 refused.  Logs the
    cell shapes where its error against float64 exceeds cuBLAS f32's.
    Returns the largest difference from the plain version, over its max."""
    from repro_torch.kernels import gemm, ops, ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = [(128, 128, 128), (5, 128, 128), (200, 160, 136), (130, 1000, 300),
             (768, 2048, 160), (64, 4100, 132)]
    cells = [shape for p in passes.values() for shape, _ in p["gemm_shapes"]]
    worst, worse_than_cublas = 0.0, []
    with torch.inference_mode():
        for T, K, N in small + cells:
            x, w = gemm_operands(rng, T, K, N, dev)
            before = ops.launch_counts()["gemm"]
            y = ops.gemm(x, w)
            assert ops.launch_counts()["gemm"] == before + 1, (T, K, N)
            assert torch.equal(y, ops.gemm(x, w)), f"gemm {(T, K, N)}: two calls differ"
            plain = ref.gemm_ref(x, w, splits=gemm.plan(T, K, N, sms)[0])
            d = ((y - plain).abs().max() / plain.abs().max()).item()
            assert d <= 2e-6, (T, K, N, d)
            worst = max(worst, d)
            if (T, K, N) in cells and rel_to_f64(y, x, w) > rel_to_f64(x @ w, x, w):
                worse_than_cublas.append((T, K, N))
        x, w = gemm_operands(rng, 128, 130, 128, dev)
        expect_refusal("gemm K = 130", lambda: ops.gemm(x, w))
    log(f"kernels: gemm matches its plain version at {len(small) + len(cells)} shapes "
        f"(largest difference {worst:.3g} of max), bit for bit twice; its error against "
        f"float64 above cuBLAS f32's at {worse_than_cublas or 'no'} cell shape")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def want_launches(cfg, gemms, decode=DECODE, passes=PUMPS):
    """Launches of each kernel over ``passes`` passes of a prompt and
    ``decode`` tokens: every prefill runs flash attention once per
    attention block (an encoder-decoder model: once per encoder block, and
    twice per decoder block, self- and cross-attention), a scan once per
    recurrent block and ``gemms`` products through the 3xTF32 kernel; every
    decode step after the first token runs decode attention once per
    attention block (twice per encoder-decoder block); a dropless MoE
    launches the grouped products once a layer a step (after its leading
    dense layers).  Latent attention (MLA) runs flash at K 192 / V 128 once
    a layer (``flash_attention_mla``, within ``flash_attention``) and
    decodes with no kernel."""
    pattern = cfg.pattern
    n_attn = pattern.count("attn") + (
        cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0)
    per_block = 2 if cfg.cross_attention else 1
    moe_layers = ((cfg.n_layers if cfg.mamba_ffn else pattern.count("attn"))
                  - cfg.first_dense_layers) if cfg.moe_dropless else 0
    mla_widths = cfg.mla and cfg.v_head_dim != cfg.hd
    return {"flash_attention": (cfg.encoder_layers + per_block * n_attn) * passes,
            "flash_attention_mla": n_attn * passes if mla_widths else 0,
            "decode_attention": 0 if cfg.mla else per_block * n_attn * (decode - 1) * passes,
            "rwkv6_scan": pattern.count("rwkv6") * passes,
            "ssd_scan": pattern.count("mamba2") * passes,
            "moe_experts": moe_layers * decode * passes, "gemm": gemms * passes,
            "decode_attention_partial": 0, "alloc_all": 0, "tables": 0}


def prefill_gemms(cfg):
    """layers.mm's products in one prefill of BATCH x PROMPT that the shape
    rule sends to the 3xTF32 kernel: an attention block's q, k, v, o and its
    MLP's three (SwiGLU) or two (GELU) products (an MoE block's router,
    N = experts, stays cuBLAS and its experts are einsums); RWKV6's r, k, v,
    g, o, cm_k, cm_r, cm_v and token-shift LoRA (its rank-64 decay LoRA stays
    cuBLAS); Mamba2's in and out projections and zamba2's shared block once
    a group; whisper's encoder blocks and each decoder block's cross q, o, K
    and V; qwen2-vl's vision projection; a latent attention block's q, kv_a,
    kv_b and o, with a leading dense layer's MLP or a dropless MoE layer's
    shared expert.  Decode steps (T = BATCH) stay cuBLAS."""
    if cfg.mla:
        return cfg.n_layers * 4 + 3 * cfg.first_dense_layers + (
            3 * (cfg.n_layers - cfg.first_dense_layers) if cfg.shared_expert_ff else 0)
    kind = cfg.pattern[0]
    attn = 4 + (3 if cfg.act_fn == "silu" else 2)
    per_layer = {"rwkv6": 9, "mamba2": 2}.get(kind, 4 if cfg.is_moe else attn)
    groups = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    n = cfg.n_layers * per_layer + groups * attn
    if cfg.encoder_layers:
        n += cfg.encoder_layers * attn + cfg.n_layers * 4
    if cfg.frontend == "vision" and cfg.frontend_dim:
        n += 1
    return n


def random_extras(cfg, B, S, dev, rng):
    """Random-normal frontend stub inputs for ``cfg``, at the engine's shapes.
    The engine's zeros make the vision embeddings exactly vis_proj's bias."""
    from repro_torch.serving.engine import frontend_shapes
    return {k: rand(rng, shape, torch.float32, dev)
            for k, shape in frontend_shapes(cfg, B, S).items()}


def run_slice(dev, arch, layers=None, encoder_layers=None):
    """Serve ``arch`` at full width (``layers``, ``encoder_layers``: cut
    depth) on the card: BATCH x PUMPS requests through ServingEngine, each
    kernel launched as often as the model asks (want_launches); an MoE
    model's drops logged and apply_moe held against moe_plain; the first
    decode step's logits equal to a prefill over prompt + that token
    (REL_TOL_FULL; an MoE model's on a dropless twin); a reset cache gives
    a fresh cache's logits bit for bit, and a repeated pump the first
    pump's tokens.  Returns the launches and the slice's record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.zoo import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if encoder_layers is not None:
        cfg = cfg.replace(encoder_layers=encoder_layers)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=BATCH, prompt_len=PROMPT,
                        decode_tokens=DECODE, seed=0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(eng.params))
    log(f"slice: {arch} full width ({cfg.n_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params f32, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card); "
        f"init + warm-up {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=PROMPT).astype(np.int32)
               for _ in range(BATCH * PUMPS)]
    done = []
    ops.reset_launch_counts()
    moe.reset_drop_counts()
    for p in range(PUMPS):
        for i in range(BATCH):
            rid = p * BATCH + i
            eng.submit(Request(rid=rid, tokens=prompts[rid], arrival_s=time.time()))
        done += eng.pump()
    launches = ops.launch_counts()
    drops = moe.drop_counts()

    assert len(done) == BATCH * PUMPS, len(done)
    for c in done:
        assert c.tokens.shape == (DECODE,), c.tokens.shape
        assert ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all(), c.tokens
    want = want_launches(cfg, prefill_gemms(cfg))
    assert launches == want, (launches, want)
    log(f"slice: {arch}: {len(done)} completions in {PUMPS} pumps, launches {launches}")

    moe_stats = None
    capacity = cfg.is_moe and not cfg.moe_dropless     # a dropless MoE drops nothing
    if capacity:
        moe_stats = {"drop_share_per_layer": [d / n for d, n in drops.values()],
                     "dropped_per_layer": [d for d, _ in drops.values()],
                     "assignments_per_layer": [n for _, n in drops.values()]}
        log(f"slice: {arch}: MoE drop share per layer over the pumps (decode never "
            f"drops) {[f'{x:.4f}' for x in moe_stats['drop_share_per_layer']]}")

    # consistency at full width: decode step 1 == prefill over prompt + token;
    # an MoE model drops by capacity in the prefill, so that check runs on a
    # second model sharing the weights whose capacity factor expert_shards·E/K
    # drops nothing; a model with a frontend stub runs it on random-normal
    # frames or patches (the engine's zeros leave the vision projection out)
    model, params = eng.model, eng.params
    check = model
    if capacity:
        dropless = cfg.expert_shards * cfg.n_experts / cfg.top_k
        check = build_model(cfg.replace(capacity_factor=dropless), dev)
    toks = torch.from_numpy(np.stack(prompts[:BATCH])).to(dev)
    batch = {"tokens": toks, **eng.extras}
    extras = random_extras(cfg, BATCH, PROMPT, dev, rng)
    buf = PROMPT + DECODE + 8
    moe_in = []         # the first MoE layer's weights and input
    with torch.inference_mode():
        cache = model.init_cache(BATCH, buf, dtype=torch.float32)
        with Spy({"moe": (moe, "apply_moe")},
                 seen={"moe": lambda p, x, *a, **kw: moe_in or moe_in.extend((p, x))}):
            lg0, cache = model.prefill(params, batch, cache)
        tok = lg0.argmax(-1).to(torch.int32)[:, None]
        ctok = tok
        if check is not model or extras:
            moe.reset_drop_counts()
            lgc, cache = check.prefill(params, {"tokens": toks, **extras}, cache)
            ctok = lgc.argmax(-1).to(torch.int32)[:, None]
        lg1, _ = check.decode_step(params, ctok, cache)
        full, _ = check.prefill(params, {"tokens": torch.cat([toks, ctok], 1), **extras},
                                check.init_cache(BATCH, buf, dtype=torch.float32))
        if check is not model:
            assert all(d == 0 for d, _ in moe.drop_counts().values()), moe.drop_counts()
            moe_stats.update(dropless_capacity_factor=dropless,
                             **moe_against_plain(cfg, *moe_in))
        # the same prompt from the used cache, without and with reset_cache
        stale, _ = model.prefill(params, batch, cache)
        again, _ = model.prefill(params, batch, model.reset_cache(cache))
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

    stats = {"arch": arch, "layers": cfg.n_layers, "batch": BATCH, "prompt_len": PROMPT,
             "decode_tokens": DECODE, "requests": len(done), "launches": launches,
             "decode_vs_prefill_rel_err": rel, "unreset_cache_rel_err": stale_rel}
    if moe_stats:
        stats["moe"] = moe_stats
    # a pump of the first pump's prompts again: the engine's cache, reset,
    # must give the same tokens (a state left from the last pass would not)
    for i, p in enumerate(prompts[:BATCH]):
        eng.submit(Request(rid=BATCH * PUMPS + i, tokens=p, arrival_s=time.time()))
    again = eng.pump()
    assert all(np.array_equal(a.tokens, c.tokens) for a, c in zip(again, done[:BATCH])), \
        "a repeated pump gave other tokens"
    log(f"slice: {arch}: a repeated pump returns the first pump's tokens")
    del eng, model, check, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def per_call_rope_freqs(head_dim, theta, device=None):
    """RoPE's frequencies as a host tensor's power: the per-call formula
    ``rope.rope_freqs`` replaced, whose copy of theta to the card blocks
    the stream."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.tensor(theta, dtype=torch.float32, device=device) ** (-2.0 * dim / head_dim)


class SyncErrors:
    """A proxy of a ServingEngine's model that keeps each prefill's logits.
    With ``guard``, each pass, from ``reset_cache`` (just after the token
    upload) to the span ``engine.fetch`` (just before the copy back), runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a call that
    synchronises with the card raises there.  With ``eager``, each prefill
    is ``transformer.prefill`` itself, run eagerly: the model's replayed
    graph never runs the pass's Python."""

    def __init__(self, model, guard, eager=False):
        self._model, self.guard, self.eager, self.logits = model, guard, eager, []

    def reset_cache(self, cache):
        if self.guard:
            torch.cuda.set_sync_debug_mode("error")
        return self._model.reset_cache(cache)

    def prefill(self, params, batch, cache, **kwargs):
        if self.eager:
            from repro_torch.models import transformer
            logits, cache = transformer.prefill(params, self._model.cfg, batch, cache, **kwargs)
        else:
            logits, cache = self._model.prefill(params, batch, cache, **kwargs)
        self.logits.append(logits)
        return logits, cache

    def __getattr__(self, name):
        return getattr(self._model, name)


@contextlib.contextmanager
def sync_errors(eng, guard=True, eager=False):
    """Inside the block, ``eng``'s passes dispatch under ``SyncErrors``."""
    from repro_torch.profiling import spans
    span, model = spans.span, eng.model

    def fetch_unguarded(name):
        if name == "engine.fetch":
            torch.cuda.set_sync_debug_mode(0)
        return span(name)

    eng.model, spans.span = SyncErrors(model, guard, eager), fetch_unguarded
    try:
        yield eng.model
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng.model, spans.span = model, span


def benchmark_cells():
    """{workload: (Cell, ArchConfig)} of every workload in BENCHMARK.json,
    read by perfbench's own readers (harness.cell.load_cell,
    harness.bench.program_config)."""
    if str(BENCH_TREE) not in sys.path:
        sys.path.insert(0, str(BENCH_TREE))
    from harness.bench import program_config
    from harness.cell import MANIFEST, load_cell, load_json
    cells = {w["name"]: load_cell(w["name"]) for w in load_json(MANIFEST)["workloads"]}
    return {name: (cell, program_config(cell)[0]) for name, cell in cells.items()}


def kernel_shapes(cell, cfg):
    """The shapes at which a cell's prefill calls the Mamba2 scan and the
    grouped expert products, where its model has them: {"ssd_scan": (B, S,
    H, hd, N), "moe_experts": (T, D, F, E, held, K)}."""
    from repro_torch.models import ssm
    B, S = cell.traffic["batch_size"], cell.traffic["prompt_len"]
    shapes = {}
    if "mamba2" in cfg.pattern:
        d_in, H, _, N, _ = ssm._dims(cfg)
        shapes["ssd_scan"] = (B, S, H, d_in // H, N)
    if cfg.moe_dropless:
        shapes["moe_experts"] = (B * S, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_held,
                                 cfg.top_k)
    return shapes


def check_cell_pass(dev, name, cell, cfg):
    """One served pass of the benchmark cell ``name`` at its configuration
    and traffic (perfbench's build_engine, the engine's seeded weights).
    Building the engine captures its prefill as a CUDA graph; two passes
    under ``sync_errors`` replay it: no call between the token upload and
    the fetch synchronises with the card; the two passes' tokens and logits
    are equal bit for bit, and equal to a third pass's, which runs
    ``transformer.prefill`` eagerly under the guard too; each kernel
    launches as the layers ask (want_launches) and the products through the
    3xTF32 kernel and left to cuBLAS are GEMM_CELL_PASS's, as the replays
    count them.  A dropless MoE counts every layer's held assignments and
    drops none; a model that rotates positions passes check_rotation.
    Returns the pass's record, with the (T, K, N) shapes the product kernel
    ran in the captured pass and their calls, the most called first."""
    from harness.bench import build_engine
    from repro_torch.kernels import gemm, ops
    from repro_torch.models import moe
    from repro_torch.profiling import spans
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    spans.reset_graph_counts()
    shapes = collections.Counter()      # the product kernel's (T, K, N), launch by launch
    capturing = torch.cuda.is_current_stream_capturing
    with Spy({"gemm": (gemm, "_launch")},
             seen={"gemm": lambda *a: capturing() and shapes.update([a[4:]])}):
        eng = build_engine(cell, cfg, None, dev)
    built = spans.graph_counts()
    assert built == {"captured": 1, "replayed": 0, "eager": 0}, (name, built)
    B, S = eng.batch_size, eng.prompt_len
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, size=(B, S)).astype(np.int32)
    moe.reset_held_counts()
    ops.reset_launch_counts()
    with sync_errors(eng) as guard:
        out = eng._serve(tokens)
        out_again = eng._serve(tokens)
    replays = spans.graph_counts()
    launches = {k: n // 2 for k, n in ops.launch_counts().items()}
    declined = gemm.gemm.declined // 2
    assert replays == {"captured": 1, "replayed": 2, "eager": 0}, (name, replays)
    assert len(guard.logits) == 2 and np.array_equal(out, out_again), f"{name}: passes differ"
    assert torch.equal(guard.logits[0], guard.logits[1]), f"{name}: logits differ between passes"
    routed, want_declined = GEMM_CELL_PASS[name]
    want = want_launches(cfg, routed, eng.decode_tokens, 1)
    assert launches == want, (name, launches, want)
    assert declined == want_declined, (name, declined)
    stats = {"cell": name, "arch": cfg.name, "layers": cfg.n_layers, "batch": B,
             "prompt_len": S, "sync_free": True, "replayed": True,
             "launches_a_pass": {k: n for k, n in launches.items() if n},
             "gemm_declined_a_pass": declined,
             "gemm_shapes": sorted(shapes.items(), key=lambda sn: -sn[1])}
    if cfg.moe_dropless:
        counts = moe.held_counts()
        assert len(counts) == want["moe_experts"] and all(
            c["dropped"] == 0 and c["assignments"] > 0 and c["calls"] == 2
            for c in counts.values()), counts
        tiles, experts = (sum(c[k] for c in counts.values()) for k in ("tiles", "experts"))
        stats.update(experts_held=cfg.n_held, dropped=0,
                     held_assignments_a_pass=sum(c["assignments"] for c in counts.values()) // 2,
                     largest_expert_rows=max(c["max_rows"] for c in counts.values()),
                     tiles_a_pass=tiles // 2, weight_streams_an_expert=tiles / experts)
    with sync_errors(eng, eager=True) as eager:
        out_eager = eng._serve(tokens)
    assert np.array_equal(out, out_eager) and torch.equal(guard.logits[0], eager.logits[0]), \
        f"{name}: the replayed pass differs from the eager pass"
    stats["replay_equals_eager"] = True
    if cfg.rope_theta > 0 and cfg.attn_layers:
        stats.update(check_rotation(eng, tokens, guard.logits[0], out))
    stats.update(memory_peak_bytes=torch.cuda.max_memory_allocated(dev),
                 seconds=time.perf_counter() - t0)
    log(f"cell: {name} ({cfg.name}, {cfg.n_layers} layers, {B} x {S}): captured at build; no "
        f"synchronising call in the dispatch, two replayed passes bit for bit equal to each other "
        f"and to the eager pass; launches a pass "
        f"{stats['launches_a_pass']}, {declined} products left to cuBLAS; products "
        f"(T, K, N) x calls {stats['gemm_shapes']}"
        + (f"; {stats['held_assignments_a_pass']} held assignments a pass, none dropped, "
           f"{stats['tiles_a_pass']} token tiles a pass, "
           f"{stats['weight_streams_an_expert']:.4f} weight streams a held expert with rows"
           if cfg.moe_dropless else "") + f"; {stats['seconds']:.1f} s")
    del eng, guard
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def check_rotation(eng, tokens, logits, out):
    """A model that rotates positions builds one rotation table a prefill
    (and one a layer a decode step), as a replayed pass counts it; its
    pass's ``logits`` and tokens (``out``) equal, bit for bit, those of
    ``transformer.prefill`` run eagerly with RoPE's per-call formula in
    ``rope_freqs``'s place (a replay never calls it), which ``sync_errors``
    refuses."""
    from repro_torch.models import rope
    built = rope.position_table.built
    eng._serve(tokens)
    built = rope.position_table.built - built
    want = 1 + len(eng.cfg.attn_layers) * (eng.decode_tokens - 1)
    assert built == want, f"the served pass built {built} rotation tables, not {want}"
    formula, rope.rope_freqs = rope.rope_freqs, per_call_rope_freqs
    try:
        try:
            with sync_errors(eng, eager=True):
                eng._serve(tokens)
        except RuntimeError as e:
            assert "synchroniz" in str(e), e
            refused = str(e).splitlines()[0]
        else:
            raise AssertionError("the sync guard let RoPE's host copy through")
        with sync_errors(eng, guard=False, eager=True) as control:
            out_formula = eng._serve(tokens)
    finally:
        rope.rope_freqs = formula
    assert torch.equal(logits, control.logits[0]), "the device-built rotation changes the logits"
    assert np.array_equal(out, out_formula)
    log(f"cell: one rotation table a prefill, logits equal to the per-call formula's bit for "
        f"bit; that formula refused ({refused})")
    return {"rope_theta": eng.cfg.rope_theta, "tables_a_pass": built,
            "logits_equal_per_call_formula": True, "per_call_formula_refused": refused}


def moe_against_plain(cfg, p, x):
    """apply_moe against moe_plain (the reference's one-hot einsums) on one
    layer's prefill input at the published capacity factor: outputs within
    REL_TOL_SMALL of max|y|, aux losses and dropped assignments equal."""
    from repro_torch.models import moe
    moe.reset_drop_counts()
    y, aux = moe.apply_moe(p, x, cfg)
    y_plain, aux_plain = moe.moe_plain(p, x, cfg)
    dropped, total = moe.drop_counts()[0]
    n, Sc, C = moe._chunking(x.shape[1], cfg, 512)
    ids, gates, _ = moe._route(p["router"], x, cfg.top_k)
    kept = sum(float(moe._dispatch_combine(ids[:, i * Sc:(i + 1) * Sc], gates[:, i * Sc:(i + 1) * Sc],
                                           cfg.n_experts, C, cfg.expert_shards)[0].sum())
               for i in range(n)) / cfg.expert_shards
    rel = rel_err(y, y_plain)
    log(f"moe: {cfg.name} layer 0, full width: apply_moe vs moe_plain rel. err {rel:.3g} "
        f"(limit {REL_TOL_SMALL}); dropped {dropped} of {total} assignments "
        f"({dropped / total:.4f}), the plain version {total - kept:.0f}; capacity {C} a virtual "
        f"expert, {moe._fillable(C, Sc, cfg.expert_shards)} fillable")
    assert rel <= REL_TOL_SMALL, rel
    assert dropped == total - kept, (dropped, total - kept)
    assert abs(float(aux) - float(aux_plain)) <= 1e-6 * abs(float(aux_plain)), (aux, aux_plain)
    return {"apply_moe_vs_plain_rel_err": rel, "layer0_prefill_dropped": dropped,
            "layer0_prefill_assignments": total, "capacity": C}


@contextlib.contextmanager
def record_routes():
    """Inside the block, every MoE routing appends its (top-k ids, probs)
    to the list it yields; a routing inside a CUDA graph's capture (which
    computes nothing yet) appends nothing."""
    from repro_torch.models import moe
    route, seen = moe._route, []

    def keep(router_w, x, top_k, *gating):
        out = route(router_w, x, top_k, *gating)
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            seen.append((out[0], out[2].detach()))
        return out

    moe._route = keep
    try:
        yield seen
    finally:
        moe._route = route


def check_routes(arch, cpu, card, top_k):
    """The card's routed expert ids equal the CPU's, call for call; the
    smallest gap between a token's k-th and (k+1)-th probability names how
    near a tie came to flipping."""
    assert len(cpu) == len(card) > 0, (len(cpu), len(card))
    gap = min(float((t[..., top_k - 1] - t[..., top_k]).min())
              for t in (p.sort(-1, descending=True).values for _, p in cpu))
    for n, ((ids_cpu, _), (ids_card, _)) in enumerate(zip(cpu, card)):
        assert torch.equal(ids_cpu, ids_card.cpu()), \
            f"{arch}: routing call {n} picked other experts on the card (smallest gap {gap:.3g})"
    log(f"small: reduced {arch}: the card routes every token to the CPU's experts "
        f"({len(card)} routings); smallest top-{top_k} / {top_k + 1} probability gap {gap:.3g}")
    return gap


def check_small_against_cpu(dev, arch):
    """A reduced ``arch`` on the card against the same weights on the CPU
    (plain path): logits of prefill and three decode steps, and for an MoE
    model the routed experts; random-normal frames or patches where the
    model takes them.  zamba2 keeps two groups (4 layers)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_map
    cfg = get_config(arch)
    cfg = reduced(cfg, layers=4 if cfg.shared_attn_every else 2)
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, dev)
    params_cpu = cpu_model.init(seed=1)
    params_gpu = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    extras = random_extras(cfg, 2, 24, "cpu", rng)
    with torch.inference_mode():
        with record_routes() as routes_cpu:
            lc, cc = cpu_model.prefill(params_cpu, {"tokens": tokens, **extras},
                                       cpu_model.init_cache(2, 32, dtype=torch.float32))
            want, toks = [lc], []
            for _ in range(3):
                toks.append(lc.reshape(2, -1).argmax(-1).to(torch.int32)[:, None])
                lc, cc = cpu_model.decode_step(params_cpu, toks[-1], cc)
                want.append(lc)
        with record_routes() as routes_card:
            lg, gc_ = gpu_model.prefill(params_gpu, {"tokens": tokens.to(dev),
                                                     **tree_map(lambda t: t.to(dev), extras)},
                                        gpu_model.init_cache(2, 32, dtype=torch.float32))
            got = [lg]
            for tok in toks:
                lg, gc_ = gpu_model.decode_step(params_gpu, tok.to(dev), gc_)
                got.append(lg)
    if cfg.is_moe:
        check_routes(arch, routes_cpu, routes_card, cfg.top_k)
    worst = max(rel_err(g.cpu(), w) for g, w in zip(got, want))
    log(f"small: reduced {arch} on the card vs CPU, worst rel. err {worst:.3g} "
        f"(limit {REL_TOL_SMALL})")
    assert worst <= REL_TOL_SMALL, worst
    return worst


# ---------------------------------------------------------------------------
# Phase 5: timing at the slice's shapes
# ---------------------------------------------------------------------------

def time_flash(dev, rng, H=32, KV=8, hd=128, S=PROMPT, Skv=None, causal=True, hdv=None):
    """Flash attention at a served model's prefill shape (qwen3-4b's heads
    by default; Skv: a kv length of its own, without a mask; hdv: a V width
    of its own, MLA's 128 beside a q.k width of 192): the kernel against
    its plain version on the timed inputs (max_abs_err), kernel, plain
    version and SDPA device times, and bound."""
    import repro_torch.kernels.flash_attention as kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Skv, hdv = BATCH, S if Skv is None else Skv, hd if hdv is None else hdv
    q = rand(rng, (B, S, H, hd), torch.float32, dev)
    k = rand(rng, (B, Skv, KV, hd), torch.float32, dev)
    v = rand(rng, (B, Skv, KV, hdv), torch.float32, dev)
    with torch.inference_mode():
        err = check_close(f"flash timed {B, S, Skv, H, KV, hd, causal}",
                          flash_attention(q, k, v, causal=causal),
                          ref.attention_ref(q, k, v, causal=causal), TOL[torch.float32])
    # the yardstick: SDPA's efficient kernel on K/V expanded to H heads
    # outside the timed call (with enable_gqa, f32 SDPA runs only its math
    # backend); that math-backend time is kept beside it where H > KV
    qt, kg, vg = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous() for t in (k, v))
    with torch.inference_mode():
        ms = device_ms(lambda i: flash_attention(q, k, v, causal=causal), 1)
        plain_ms = device_ms(lambda i: ref.attention_ref(q, k, v, causal=causal), 1, iters=5)
        lib = library_times(
            lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 1),
            None if H == KV else lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kg, vg, is_causal=causal, enable_gqa=True), 1))
    flops = kernel.flops(q.shape, k.shape, v.shape, causal, None)
    nbytes = 4 * (B * S * H * (hd + hdv) + B * Skv * KV * (hd + hdv))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "shape": {"B": B, "S": S, "Skv": Skv, "H": H, "KV": KV, "hd": hd, "causal": causal,
                      **({"hdv": hdv} if hdv != hd else {})},
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes), **lib}


def time_decode(dev, rng, H=32, KV=8, hd=128, cross_frames=None, partial=False):
    """Decode attention at a served model's first decode step (qwen3-4b's
    heads by default; cross_frames: an encoder-decoder model's cross cache
    of that many frames, (B, Se, KV, hd), q at position Se - 1), over
    enough cache copies to exceed the L2 cache: the kernel against its
    plain version on the first copy (max_abs_err), kernel, plain version
    and SDPA device times, and bound.  partial: the partial variant
    (decode_attention_partial, its output in float32 beside the lse) on
    the same inputs; SDPA's yardstick computes its output only."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_partial
    if partial:
        decode_attention = lambda *a: decode_attention_partial(*a)[0]
        plain = lambda *a: ref.decode_attention_partial_ref(*a)[0]
    else:
        plain = ref.decode_attention_ref
    n_copies = 8                                  # 8 x 17 MB of cache > 50 MB L2
    if cross_frames is None:
        q, caches, qpos, kvpos = decode_inputs(dev, rng, n_copies, H, KV, hd)
        views = [(kc.transpose(1, 2), vc.transpose(1, 2)) for kc, vc in caches]
    else:
        B, Se = BATCH, cross_frames
        q = rand(rng, (B, 1, H, hd), torch.float32, dev)
        views = [(rand(rng, (B, Se, KV, hd), torch.float32, dev),
                  rand(rng, (B, Se, KV, hd), torch.float32, dev)) for _ in range(n_copies)]
        caches = [(kc.transpose(1, 2), vc.transpose(1, 2)) for kc, vc in views]
        kvpos = torch.arange(Se, dtype=torch.int32, device=dev)[None].expand(B, Se)
        qpos = torch.full((B,), Se - 1, dtype=torch.int32, device=dev)
    B, S_buf = q.shape[0], caches[0][0].shape[2]
    mask = (kvpos >= 0) & (kvpos <= qpos[:, None])
    qh = q.transpose(1, 2)                        # (B, H, 1, hd)
    expanded = [tuple(c.repeat_interleave(H // KV, dim=1) for c in kv) for kv in caches]
    with torch.inference_mode():
        err = check_close(f"decode timed {B, S_buf, H, KV, hd}",
                          decode_attention(q, *views[0], qpos, kvpos),
                          plain(q, *views[0], qpos, kvpos), TOL[torch.float32])
        per_call = {}
        ms = device_ms(lambda i: decode_attention(q, *views[i], qpos, kvpos), n_copies, 40,
                       per_call=per_call)
        assert list(per_call.values()) == [1] and "decode_attn_kernel" in next(iter(per_call)), \
            f"decode_attention: one kernel launch per call, got {per_call}"
        plain_ms = device_ms(lambda i: plain(q, *views[i], qpos, kvpos), n_copies, 16)
        lib = library_times(
            lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qh, *expanded[i], attn_mask=mask[:, None, None, :]), n_copies, 40),
            None if H == KV else lambda: device_ms(lambda i: F.scaled_dot_product_attention(
                qh, caches[i][0], caches[i][1], attn_mask=mask[:, None, None, :],
                enable_gqa=True), n_copies, 40))
    del expanded
    valid = int(mask.sum())                       # valid (b, slot) pairs
    flops = 4 * hd * H * valid
    nbytes = 4 * (2 * B * KV * S_buf * hd + B * S_buf + B + 2 * B * H * hd
                  + (B * H if partial else 0))
    return {"name": "decode_attention_partial" if partial else "decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:64",
            "shape": {"B": B, "slots": S_buf, "H": H, "KV": KV, "hd": hd,
                      "cache": "cross" if cross_frames else "self"},
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
    import repro_torch.kernels.rwkv6_scan as kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    B, S, H, hd = RWKV_SHAPE
    r, k, v, logw, u = rwkv_inputs(rng, B, S, H, hd, torch.float32, dev)
    s0 = torch.zeros((B, H, hd, hd), device=dev)
    with torch.inference_mode():
        ms = device_ms(lambda i: rwkv6_scan(r, k, v, logw, u, s0=s0), 1)
        # thousands of small kernels a call: the profiler's own cost grows with them
        plain_ms = device_ms(lambda i: ref.rwkv6_ref(r, k, v, logw, u, s0), 1, iters=1, warmup=1)
    flops = kernel.flops(r.shape)
    nbytes = 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:60",
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
            "library_ms": None}


def time_ssd(dev, rng, err, shape=SSD_SHAPE):
    """ssd_scan at zamba2-2.7b's prefill (or ``shape``): B and C in group
    form expanded over the heads and a zero initial state, as the Mamba2
    block passes them; no single PyTorch call computes the recurrence."""
    import repro_torch.kernels.ssd_scan as kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    B, S, H, hd, N = shape
    xdt, Bm, Cm, dA = ssd_inputs(rng, B, S, H, hd, N, torch.float32, dev, group=True)
    h0 = torch.zeros((B, H, hd, N), device=dev)
    with torch.inference_mode():
        ms = device_ms(lambda i: ssd_scan(xdt, Bm, Cm, dA, h0=h0), 1)
        plain_ms = device_ms(lambda i: ref.ssd_ref(xdt, Bm, Cm, dA, h0), 1, iters=1, warmup=1)
    flops = kernel.flops(xdt.shape, Bm.shape)
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * N + B * S * H + 2 * B * H * hd * N)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:55",
            "max_abs_err": err, "shape": shape,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
            "library_ms": None}


def time_moe(dev, rng, err, shape):
    """The grouped expert products at a cell's ``shape`` (T, D, F, E, held,
    K) (one call: the gate and up products, the down product, the
    combine); no single PyTorch call computes them without the expert
    counts on the host."""
    from repro_torch.kernels import ops, ref
    T, D, F, E, held, K = shape
    args = moe_inputs(rng, *shape, dev)
    rows = int(args[2][-1])
    with torch.inference_mode():
        ms = device_ms(lambda i: ops.moe_experts(*args), 1)
        plain_ms = device_ms(lambda i: ref.moe_experts_ref(*args), 1, iters=3, warmup=1)
    # the three products of the held rows; bytes: the held experts'
    # weights, the tokens' rows, the SwiGLU's rows out and back, the
    # weighted rows out and the combine's output
    flops = 2 * rows * 3 * D * F
    nbytes = 4 * (3 * held * D * F + rows * D + 2 * rows * F + 2 * rows * D + T * D)
    return {"name": "moe_experts", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe.cu",
            "replaces": "none (the JAX package's MoE layer drops assignments; einsums)",
            "max_abs_err": err, "shape": shape, "rows": rows,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
            "library_ms": None}


def host_us(fn, calls=50, reps=7):
    """Host microseconds a call of fn, issued while the card is kept busy
    (so the host never waits on it): the median of reps runs of calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(300_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def time_gemm(dev, rng, err, passes):
    """The 3xTF32 product kernel at every shape the cells' ``passes``
    (check_cell_pass) sent through layers.mm: its device ms (CUDA events
    over 20 calls back to back), its bound (2 T K N at 165 TFLOP/s) and
    share, its plain version's and cuBLAS f32's ms, both errors against
    float64, and the products' ms a pass of each cell; at a cell's most
    called shape layers.mm's host microseconds a call to the kernel, beside
    layers.mm's to cuBLAS (its path before the kernel) and aten::mm's
    alone."""
    from repro_torch.kernels import gemm, ref
    from repro_torch.models import layers
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, cells = [], {}
    with torch.inference_mode():
        for cell, p in passes.items():
            kernel_pass = cublas_pass = 0.0
            for (T, K, N), calls in p["gemm_shapes"]:
                x, w = gemm_operands(rng, T, K, N, dev)
                # CUDA events, not torch.profiler: the plain version's thousands of
                # small kernels would make later profiler runs drop records (device_ms)
                ms = event_ms(lambda: gemm.gemm(x, w), iters=20)[0]
                lib_ms = event_ms(lambda: x @ w, iters=20)[0]
                plain_ms = train_event_ms(lambda: ref.gemm_ref(x, w), iters=2)
                flops, nbytes = 2 * T * K * N, 4 * (T * K + K * N + T * N)
                row = {"name": "gemm", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/gemm.cu",
                       "replaces": "none: replaces cuBLAS f32 in layers.mm",
                       "cell": cell, "shape": [T, K, N], "calls_a_pass": calls,
                       "splits": gemm.plan(T, K, N, sms)[0], "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes),
                       "library_ms": lib_ms, "tflop_per_s": flops / ms / 1e9,
                       "err_f64": rel_to_f64(gemm.gemm(x, w), x, w),
                       "library_err_f64": rel_to_f64(x @ w, x, w)}
                rows.append(row)
                kernel_pass += calls * ms
                cublas_pass += calls * lib_ms
            T, K, N = p["gemm_shapes"][0][0]
            x, w = gemm_operands(rng, T, K, N, dev)
            cells[cell] = {"launches_a_pass": p["launches_a_pass"]["gemm"],
                           "declined_a_pass": p["gemm_declined_a_pass"],
                           "products_ms_a_pass": kernel_pass,
                           "library_products_ms_a_pass": cublas_pass,
                           "host_us_a_call": host_us(lambda: layers.mm(x, w)),
                           "host_us_shape": [T, K, N]}
            take, gemm.take = gemm.take, lambda x, w: None     # mm as it was: x @ w
            try:
                cells[cell]["library_host_us_a_call"] = host_us(lambda: layers.mm(x, w))
            finally:
                gemm.take = take
            cells[cell]["aten_mm_host_us_a_call"] = host_us(lambda: x @ w)
    for r in rows:
        log(f"timing: gemm {r['cell']} {r['shape']} x {r['calls_a_pass']}: {r['ms']:.4f} ms "
            f"({r['tflop_per_s']:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.1%} of bound, "
            f"{r['splits']} parts of K), cuBLAS f32 {r['library_ms']:.4f} "
            f"({r['library_ms'] / r['ms']:.2f}x), plain {r['plain_ms']:.4f}; error against "
            f"float64 {r['err_f64']:.3g} (cuBLAS {r['library_err_f64']:.3g})")
    for cell, c in cells.items():
        log(f"timing: gemm {cell}: products {c['products_ms_a_pass']:.2f} ms a pass "
            f"(cuBLAS f32 {c['library_products_ms_a_pass']:.2f}); host {c['host_us_a_call']:.2f} "
            f"us a call through layers.mm, {c['library_host_us_a_call']:.2f} through layers.mm "
            f"to cuBLAS, aten::mm alone {c['aten_mm_host_us_a_call']:.2f}")
    return rows, cells


def log_timing(k, what=None):
    lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
    if "library_math_ms" in k:
        lib += f" (math backend {k['library_math_ms']:.4f})"
    log(f"timing: {what or k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
        f"library {lib}, bound {k['bound_ms']:.4f} by {k['bound_by']}, "
        f"on the CUDA cores {k['bound_f32_cores_ms']:.4f}); "
        f"plain / kernel = {k['plain_ms'] / k['ms']:.2f}, "
        f"{k['bound_ms'] / k['ms']:.1%} of bound"
        + (f"; max_abs_err {k['max_abs_err']:.3g}" if "max_abs_err" in k else ""))


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
    out = {}
    for backend in ("numpy", "torch"):
        with Spy({"alloc_all": (pmv.VecCluster, "alloc_all")}) as spy:
            _, wall = provision(1000, "queueing", backend)
        spent = spy.seconds["alloc_all"]
        out[backend] = {"wall_s": wall, "alloc_all_s": spent, "alloc_all_share": spent / wall}
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _, wall = provision(1000, "queueing", "torch")
    out["torch_profiled"] = device_groups(prof, wall, ("alloc_all_kernel",))
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
    from repro_torch.core.experiments import fitted_context
    from repro_torch.core.types import PlannerConfig
    from repro_torch.kernels import grant_loop, ops
    from repro_torch.serving.workload import synthetic_workloads, twelve_workloads
    ctx = fitted_context("tpu-v5e")
    workloads = {12: twelve_workloads(), 1000: synthetic_workloads(1000, 0)}

    def provision(m, budget, backend):
        cfg = PlannerConfig(backend=backend, budget=budget,
                            device=str(dev) if backend == "torch" else None)
        t0 = time.perf_counter()
        plan = prov.provision(workloads[m], ctx.profiles, ctx.hw, config=cfg)
        if backend == "torch":
            torch.cuda.synchronize()
        return plan, time.perf_counter() - t0

    # record the cluster and the newcomer of m = 1000's last grant-loop call
    last = {}
    plans, refs, launches_m1000 = [], {}, None
    for m, budget in PLANNER_DEVICES:
        ref, _ = provision(m, budget, "numpy")
        refs[(m, budget)] = plan_key(ref)
        ops.reset_launch_counts()
        seen = {"alloc_all": lambda cl, *args: last.update(cl=cl, args=args)}
        with Spy({"alloc_all": (pmt, "alloc_all_torch")},
                 seen=seen if (m, budget) == (1000, "queueing") else None):
            plan, _ = provision(m, budget, "torch")
        launches = ops.launch_counts()
        assert plan_key(plan) == plan_key(ref), f"m={m} {budget}: torch and numpy plans differ"
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
            assert plan_key(plan) == refs[(1000, "queueing")], backend
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


# ---------------------------------------------------------------------------
# Phase 7: the simulator (the latency tables behind backend="torch")
# ---------------------------------------------------------------------------

SIM_DEVICES = 766              # the m = 1000 plan (queueing budget), as phase 6 finds
SIM_DURATION_S = 10.0          # benchmarks/scale_sweep.py:87's simulated seconds
# float64 operations of the table build: per element (the solo terms, cache
# and power, the inflated t_act) and per row (the sums' tails, the
# frequency; each pow counted as one)
TABLE_OPS_PER_ELEMENT, TABLE_OPS_PER_ROW = 46, 12


def table_inputs(rng, rows, n, ranges="reference"):
    """The eight (rows, n) inputs of physics.device_state_arrays: the
    reference test's ranges (tests/test_perf_model_jax.py:161), or those
    ranges with a third of the rows over-subscribed (shares x 2.5) and a
    third weight-heavy (weights x 50, past the bandwidth knee)."""
    shape = (rows, n)
    args = [rng.uniform(1e6, 1e8, shape), rng.uniform(1e5, 1e7, shape),
            rng.uniform(1e9, 1e12, shape), rng.uniform(1e7, 1e9, shape),
            rng.uniform(1e5, 1e7, shape), rng.integers(20, 400, shape).astype(float),
            rng.integers(1, 33, shape).astype(float), rng.uniform(0.05, 0.6, shape)]
    if ranges != "reference":
        kind = rng.integers(0, 3, size=(rows, 1))
        args[7] = args[7] * np.where(kind == 1, 2.5, 1.0)
        args[3] = args[3] * np.where(kind == 2, 50.0, 1.0)
    return args


def table_cases(rng):
    """(label, inputs, n): the reference test's four widths at its row
    counts, then seeded mixed grids at n = 1, 2, 3, 5, 8 and 16 with R = 1,
    37, 4099 and one full _BULK_CHUNK of elements."""
    from repro_torch.serving import simulator
    for n in (1, 2, 3, 5):
        yield f"reference n={n}", table_inputs(rng, int(rng.integers(4, 64)), n), n
    for n in (1, 2, 3, 5, 8, 16):
        for rows in (1, 37, 4099, simulator._BULK_CHUNK // n):
            yield f"mixed n={n} R={rows}", table_inputs(rng, rows, n, "mixed"), n


def check_tables(dev, rng):
    """tables_kernel against its plain version on the card and against the
    port's numpy physics.device_state_arrays, within PLANNER_TOL (the
    reference's contract for its JAX twin); counts the values bit-identical
    to numpy, and the rows over-subscribed, over the power cap and past the
    bandwidth knee (both pow branches run).  A width of 17 must be
    refused."""
    from repro_torch.core.types import V5E
    from repro_torch.kernels import tables
    from repro_torch.serving import physics, physics_torch
    stats = {"cases": 0, "values": 0, "bit_identical_kernel": 0, "bit_identical_plain": 0,
             "rows": 0, "rows_oversubscribed": 0, "rows_over_power_cap": 0,
             "rows_past_knee": 0, "widths": set(), "max_rows": 0}
    err = 0.0
    for label, args, n in table_cases(rng):
        ref = physics.device_state_arrays(*args, n, V5E)
        want = (ref.t_load, ref.t_sched, ref.t_act, ref.t_feedback, ref.freq)
        buf, rows = physics_torch.pack(*args, n, V5E)
        packed = torch.from_numpy(buf).to(dev)
        outs = {"kernel": tables.tables(packed, rows, n),
                "plain": tables.tables_plain(packed, rows, n)}
        for name, out in outs.items():
            got = tables.split_out(out.cpu().numpy(), rows, n)
            for field, g, a in zip(tables.OUTPUTS + ("freq",), got, want):
                np.testing.assert_allclose(g, a, err_msg=f"{label} {name} {field}",
                                           **PLANNER_TOL)
                stats[f"bit_identical_{name}"] += int((g == a).sum())
        err = max(err, float((outs["kernel"] - outs["plain"]).abs().max()))
        stats["cases"] += 1
        stats["values"] += sum(a.size for a in want)
        stats["rows"] += rows
        stats["rows_oversubscribed"] += int((args[7].sum(axis=1) > 1.0).sum())
        stats["rows_over_power_cap"] += int((ref.device_power > V5E.power_cap).sum())
        stats["rows_past_knee"] += int((ref.cache_util.sum(axis=1) > physics.BW_KNEE).sum())
        stats["widths"].add(n)
        stats["max_rows"] = max(stats["max_rows"], rows)
    stats["widths"] = sorted(stats["widths"])
    assert min(stats[k] for k in ("rows_oversubscribed", "rows_over_power_cap",
                                  "rows_past_knee")) > 0, stats
    wide = tables.CAPACITY + 1
    buf, rows = physics_torch.pack(*table_inputs(rng, 3, wide), wide, V5E)
    expect_refusal(f"tables at n = {wide}",
                   lambda: tables.tables(torch.from_numpy(buf).to(dev), rows, wide))
    log(f"simulator: tables_kernel and its plain version match numpy on {stats['cases']} "
        f"grids ({stats['rows']} rows, {stats['values']} values, widths "
        f"{stats['widths']}, up to {stats['max_rows']} rows; "
        f"{stats['rows_oversubscribed']} rows over-subscribed, "
        f"{stats['rows_over_power_cap']} over the power cap, {stats['rows_past_knee']} "
        f"past the knee); bit-identical values: kernel {stats['bit_identical_kernel']}, "
        f"plain {stats['bit_identical_plain']} of {stats['values']}; kernel vs plain "
        f"max_abs_err {err:.3g}; n = {wide} refused")
    return stats, err


def compare_runs(label, ref, got, specs):
    """The torch backend's contract against numpy: identical violations and
    request and pass counts, every stream of the same shape and within
    PLANNER_TOL.  Returns the count of latencies bit-identical to numpy's."""
    assert got.violations(specs) == ref.violations(specs), label
    for k in ("n_requests", "n_passes"):
        assert got.stats[k] == ref.stats[k], (label, k)
    assert list(got.request_latencies) == list(ref.request_latencies), label
    same = 0
    for w, lat in ref.request_latencies.items():
        g = got.request_latencies[w]
        assert g.shape == lat.shape, (label, w)
        np.testing.assert_allclose(g, lat, err_msg=f"{label} {w}", **PLANNER_TOL)
        np.testing.assert_allclose(got.request_waits[w], ref.request_waits[w],
                                   err_msg=f"{label} {w} waits", **PLANNER_TOL)
        same += int((g == lat).sum())
    return same


class Spy:
    """Wraps module functions for one block: counts each one's calls and
    sums its host seconds (with the card synchronised around it for the
    keys in ``sync``), and hands each call's arguments to ``seen[key]``."""

    def __init__(self, targets, sync=(), seen=None):
        self.targets, self.sync, self.seen = targets, set(sync), seen or {}
        self.calls = {k: 0 for k in targets}
        self.seconds = {k: 0.0 for k in targets}

    def __enter__(self):
        self.saved = {k: getattr(m, a) for k, (m, a) in self.targets.items()}
        for key, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._wrap(key, self.saved[key]))
        return self

    def _wrap(self, key, fn):
        @functools.wraps(fn)      # with its attributes: a wrapper counts launches too
        def wrapped(*args, **kw):
            if key in self.seen:
                self.seen[key](*args, **kw)
            if key in self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if key in self.sync:
                    torch.cuda.synchronize()
                self.seconds[key] += time.perf_counter() - t0
                self.calls[key] += 1
        return wrapped

    def __exit__(self, *exc):
        for key, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[key])


def table_build_breakdown(simulate):
    """Where one torch-backend simulate_full's time goes, host clock: the
    table builds (the bulk builds' wall time) and inside them the staging
    of the inputs, the packing, the kernel (the card synchronised around
    it), the copies (the rest of physics_torch.table_values) and the
    .tolist() unpacking, and the builds' share of the run; the numpy
    backend's build time beside it.  Then one profiled torch run: the
    device ms of the kernels and copies, and the card's idle share of the
    wall time."""
    from repro_torch.kernels import tables
    from repro_torch.serving import physics_torch, simulator
    targets = {"build": (simulator, "_build_tables_bulk"),
               "stage": (simulator, "_stage_chunk"), "pack": (physics_torch, "pack"),
               "kernel": (tables, "tables"), "table_values": (physics_torch, "table_values"),
               "unpack": (simulator, "_unpack_chunk")}
    out = {}
    with Spy(targets, sync=("kernel",)) as spy:
        _, wall = simulate("torch")
    s = spy.seconds
    out["torch"] = {"wall_s": wall, "table_build_s": s["build"],
                    "table_build_share": s["build"] / wall, "stage_s": s["stage"],
                    "pack_s": s["pack"], "kernel_s": s["kernel"],
                    "copies_s": s["table_values"] - s["pack"] - s["kernel"],
                    "unpack_s": s["unpack"], "builds": spy.calls["build"],
                    "chunks": spy.calls["kernel"]}
    with Spy({"build": targets["build"]}) as spy:
        _, wall = simulate("numpy")
    out["numpy"] = {"wall_s": wall, "table_build_s": spy.seconds["build"],
                    "table_build_share": spy.seconds["build"] / wall}
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _, wall = simulate("torch")
    out["torch_profiled"] = device_groups(prof, wall, ("tables_kernel",))
    log(f"simulator: breakdown at m=1000: {out}")
    return out


def time_tables(dev, chunks):
    """Device ms of tables_kernel and its plain version on the served
    chunks (the packed inputs of one simulate_full, one call each, summed)
    and at one full _BULK_CHUNK (n = 2, 2^18 rows), each beside its bound:
    every input read once and every output written once over the HBM rate,
    or the float64 operations over the CUDA cores' float64 rate."""
    from repro_torch.core.types import V5E
    from repro_torch.kernels import tables
    from repro_torch.serving import physics_torch, simulator

    def bound_of(rows, n):
        nbytes = 8 * (tables.pack_size(rows, n) + tables.out_size(rows, n))
        n_ops = TABLE_OPS_PER_ELEMENT * rows * n + TABLE_OPS_PER_ROW * rows
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, n_ops / PEAK_F64_FLOPS
        return {"bytes": nbytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def timed(packed, rows, n):
        per_call = {}
        ms = device_ms(lambda i: tables.tables(packed, rows, n), 1, iters=20,
                       per_call=per_call)
        assert list(per_call.values()) == [1] and "tables_kernel" in next(iter(per_call)), \
            f"tables: one kernel launch per call, got {per_call}"
        plain_ms = device_ms(lambda i: tables.tables_plain(packed, rows, n), 1, iters=5)
        return {"rows": rows, "n": n, "ms": ms, "plain_ms": plain_ms, **bound_of(rows, n)}

    served = [timed(torch.from_numpy(buf).to(dev), rows, n) for buf, rows, n in chunks]
    n = 2
    rows = simulator._BULK_CHUNK // n
    buf, _ = physics_torch.pack(*table_inputs(np.random.default_rng(23), rows, n, "mixed"),
                                n, V5E)
    full = timed(torch.from_numpy(buf).to(dev), rows, n)
    total = {k: sum(c[k] for c in served) for k in ("ms", "plain_ms", "bytes", "ops")}
    t_bytes, t_ops = total["bytes"] / PEAK_BYTES_S, total["ops"] / PEAK_F64_FLOPS
    total["bound_ms"] = max(t_bytes, t_ops) * 1e3
    total["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    for label, t in [*((f"served chunk n={c['n']} R={c['rows']}", c) for c in served),
                     ("served build (sum)", total), (f"full chunk n={n} R={rows}", full)]:
        log(f"timing: tables_kernel {label}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}; "
            f"bound {t['bound_ms']:.6f} by {t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} float64 operations)")
    return {"served_chunks": served, "served_build": total, "full_chunk": full}


def run_simulator(dev):
    """The simulator on the card.  synthetic_workloads(1000, 0) provisioned
    on the card (queueing budget: 766 devices) and simulated for 10 s, seed
    0, with backend="torch" on the card against backend="numpy": identical
    violations and request and pass counts, streams within PLANNER_TOL, one
    tables_kernel launch per table chunk (the counts read over that run
    alone).  The 12-workload App study with shadows, Poisson arrivals, an
    outage and a straggler (tests/test_faults.py's scenario) and a spike
    trace: torch against the numpy vec and scalar engines, identical
    violations, and one launch per shadow-activated device's rebuild.
    The kernel's times on that run's chunks and at a full chunk; then
    simulate_full's wall time for both backends (median of 3, in turns),
    and the breakdown."""
    from repro_torch.core import provisioner as prov
    from repro_torch.core.experiments import fitted_context
    from repro_torch.core.types import PlannerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import faults, physics_torch, simulator, traces
    from repro_torch.serving.workload import (models, specs_by_name, synthetic_workloads,
                                              twelve_workloads)
    ctx = fitted_context("tpu-v5e")
    mods = models()
    specs = synthetic_workloads(1000, 0)
    plan = prov.provision(specs, ctx.profiles, ctx.hw, config=PlannerConfig(device=str(dev)))
    assert plan.n_gpus == SIM_DEVICES, plan.n_gpus
    widths = {}
    for pls in plan.by_gpu().values():
        widths[len(pls)] = widths.get(len(pls), 0) + 1
    sb = {s.name: s for s in specs}

    def simulate(backend, **kw):
        t0 = time.perf_counter()
        res = simulator.simulate_full(
            plan, mods, ctx.hw, duration_s=SIM_DURATION_S, seed=0, backend=backend,
            device=str(dev) if backend == "torch" else None, **kw)
        if backend == "torch":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # the main path: every launch count read over this run alone
    chunks = []
    with Spy({"pack": (physics_torch, "pack")},
             seen={"pack": lambda *a: chunks.append(a)}) as spy:
        ops.reset_launch_counts()
        res_t, wall_t = simulate("torch")
        launches = ops.launch_counts()
    want = {k: (spy.calls["pack"] if k == "tables" else 0) for k in launches}
    assert launches == want, (launches, want)
    # the kernel's times on that run's chunks, before the long profiled run
    # below (a profiler run after a long one drops records: see device_ms)
    times = time_tables(dev, [(*physics_torch.pack(*a), a[8]) for a in chunks])
    res_n, wall_n = simulate("numpy")
    same = compare_runs("m=1000", res_n, res_t, sb)
    n_lat = sum(a.size for a in res_n.request_latencies.values())
    viol = res_n.violations(sb)
    log(f"simulator: m=1000, {plan.n_gpus} devices (widths {widths}), {SIM_DURATION_S} s: "
        f"{res_t.stats['n_requests']} requests, {res_t.stats['n_passes']} passes, "
        f"{len(viol)} violations, identical; {launches['tables']} tables launches "
        f"({spy.calls['pack']} chunks); {same} of {n_lat} latencies bit-identical to numpy")

    # the App study with shadows, faults and a trace
    app = prov.provision(twelve_workloads(), ctx.profiles, ctx.hw,
                         config=PlannerConfig(device=str(dev)))
    g_w3 = next(p.gpu for p in app.placements if p.workload.name == "W3")
    g_w5 = next(p.gpu for p in app.placements if p.workload.name == "W5")
    fs = faults.merge(faults.FaultSchedule(down={g_w3: [[1500.0, 4000.0]]}),
                      faults.FaultSchedule(slow={g_w5: 2.0}))
    names = [s.name for s in twelve_workloads()]
    tr = traces.step_spike(names, 8000.0, at_ms=3000.0, duration_ms=2000.0, scale=2.0)
    kw = dict(duration_s=8.0, shadow=True, poisson=True, seed=11, faults=fs, trace=tr,
              record_timeline=True)
    with Spy({"chunk": (simulator, "_build_tables_chunk")}) as spy:
        ops.reset_launch_counts()
        app_t = simulator.simulate_plan(app, mods, ctx.hw, device=str(dev), **kw)
        app_launches = ops.launch_counts()["tables"]
    app_n = simulator.simulate_plan(app, mods, ctx.hw, backend="numpy", **kw)
    app_s = simulator.simulate_plan(app, mods, ctx.hw, backend="numpy", engine="scalar", **kw)
    asb = specs_by_name()
    compare_runs("app study, scalar", app_s, app_n, asb)
    app_same = compare_runs("app study", app_n, app_t, asb)
    gpu_of = {p.workload.name: p.gpu for p in app.placements}
    first = {}
    for row in app_t.timeline:
        if row["shadow"]:
            first.setdefault(row["workload"], row["t_s"])
    activations = {(t, gpu_of[w]) for w, t in first.items()}
    initial = len({len(p) for p in app.by_gpu().values()})
    assert activations, "app study: no shadow activated"
    assert app_launches == spy.calls["chunk"] == initial + len(activations), \
        (app_launches, spy.calls, initial, activations)
    app_stats = {"devices": app.n_gpus, "violations": app_n.violations(asb),
                 "n_requests": app_t.stats["n_requests"], "shadow_activations": len(first),
                 "activated_device_ticks": len(activations), "tables_launches": app_launches,
                 "initial_chunks": initial, "latencies_bit_identical": app_same,
                 "n_failures": app_t.stats.get("n_failures")}
    log(f"simulator: app study (shadows, outage, straggler, spike): {app_stats}")

    walls = {"torch": [wall_t], "numpy": [wall_n]}
    for _ in range(2):
        for backend in walls:
            res, wall = simulate(backend)
            assert res.violations(sb) == viol, backend
            walls[backend].append(wall)
    wall_median = {b: float(np.median(w)) for b, w in walls.items()}
    log(f"simulator: simulate_full at m=1000, wall s torch {walls['torch']} numpy "
        f"{walls['numpy']}; medians {wall_median}")
    breakdown = table_build_breakdown(simulate)

    total = times["served_build"]
    entry = {"name": "tables_kernel", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/physics.cu",
             "replaces": "src/repro/serving/physics_jax.py:35",
             "launches": launches["tables"], "ms": total["ms"], "plain_ms": total["plain_ms"],
             "bound_ms": total["bound_ms"], "bound_by": total["bound_by"], "library_ms": None}
    stats = {"m": 1000, "devices": plan.n_gpus, "widths": widths,
             "duration_s": SIM_DURATION_S, "seed": 0,
             "n_requests": res_t.stats["n_requests"], "n_passes": res_t.stats["n_passes"],
             "violations": len(viol), "identical_violations": True,
             "latencies_bit_identical": same, "latencies": n_lat,
             "tables_launches": launches["tables"], "table_chunks": len(chunks),
             "app_study": app_stats, "simulate_full_wall_s": walls,
             "simulate_full_wall_s_median": wall_median, "breakdown": breakdown,
             "tables_kernel": times}
    return entry, stats


# ---------------------------------------------------------------------------
# Phase 8: the controller (the closed loop behind PlannerConfig(backend="torch"))
# ---------------------------------------------------------------------------

CONTROL_M, CONTROL_SEED = 100, 0
# benchmarks/dynamic_sweep.py runs its scenarios, m = 1000 included, for
# 10 s; 6 s (the spike fixture's horizon) and, at m = 1000, 2 s (two control
# ticks) keep the whole script under 200 s
CONTROL_HORIZON_S = 6.0
CONTROL_M1000_HORIZON_S = 2.0
CONTROL_SCENARIOS = ("no_drift", "diurnal", "spike", "churn", "overload")
# benchmarks/dynamic_sweep.py:96-104: the overload scenario's priority split
OVERLOAD_HI_EVERY, OVERLOAD_PEAK_LO, OVERLOAD_PEAK_HI, OVERLOAD_RESERVE = 4, 3.0, 1.3, 1.4
# tests/test_spike_fixture.py's pinned forecast-on spike run: the sha256 of
# the (t_s, kind, workload, replicas) sequence of its forecast / shadow_arm /
# shadow_disarm events, their counts and the reconfiguration counter
SPIKE_SEQUENCE_SHA256 = "e0ebfdbb91e2e76627ddf5c73c99c9946142243f460dbbb1ee5a076d476bd0e7"
SPIKE_EVENTS = {"forecast": 62, "shadow_arm": 58, "shadow_disarm": 0}
SPIKE_RECONFIGS = 182


def plan_key(plan):
    """A plan's placements (name, device, r to 1e-9, batch) and device count."""
    return ([(p.workload.name, p.gpu, round(p.r, 9), p.batch)
             for p in plan.placements], plan.n_gpus)


def control_trace(scenario, names, horizon_ms, seed):
    """benchmarks/dynamic_sweep.py:120-144 (_make_trace) on the port's
    traces: (trace, Poisson arrivals)."""
    from repro_torch.serving import traces
    if scenario == "no_drift":
        return traces.constant(names, horizon_ms), False
    if scenario == "diurnal":
        return traces.diurnal(names, horizon_ms, peak=2.0), False
    if scenario == "spike":
        return traces.step_spike(names, horizon_ms, at_ms=0.4 * horizon_ms,
                                 duration_ms=0.2 * horizon_ms, scale=2.5), True
    if scenario == "churn":
        return traces.random_churn(names, horizon_ms, depart_frac=0.1, arrive_frac=0.1,
                                   seed=seed), False
    hi = [n for i, n in enumerate(names) if i % OVERLOAD_HI_EVERY == 0]
    lo = [n for i, n in enumerate(names) if i % OVERLOAD_HI_EVERY != 0]
    t_lo = traces.diurnal(lo, horizon_ms, peak=OVERLOAD_PEAK_LO)
    t_hi = traces.diurnal(hi, horizon_ms, peak=OVERLOAD_PEAK_HI)
    return traces.Trace(edges=t_lo.edges, scales={**t_lo.scales, **t_hi.scales}), False


def overload_fleet(specs, ctx, cfg):
    """benchmarks/dynamic_sweep.py:147-180 (_overload_specs, _overload_plan)
    on the port's provisioner: every fourth workload priority 1, the fleet
    provisioned on tpu-v5e with that tier's rate reserved x
    OVERLOAD_RESERVE and replication on, then the true rates written back.
    Returns (specs, plan); the controller may not grow the fleet."""
    from repro_torch.core import provisioner as prov
    specs = [dataclasses.replace(s, priority=1) if i % OVERLOAD_HI_EVERY == 0 else s
             for i, s in enumerate(specs)]
    prov_specs = [dataclasses.replace(s, rate_rps=s.rate_rps * OVERLOAD_RESERVE)
                  if s.priority > 0 else s for s in specs]
    plan, _ = prov.provision_cheapest(prov_specs, {ctx.hw.name: ctx.profiles}, [ctx.hw],
                                      config=cfg.replace(replicate=True))
    placements = [dataclasses.replace(p, workload=dataclasses.replace(
        p.workload, rate_rps=p.workload.rate_rps / OVERLOAD_RESERVE))
        if p.workload.priority > 0 else p for p in plan.placements]
    return specs, dataclasses.replace(plan, placements=placements)


def scaled_specs(specs, tr, horizon_ms):
    """benchmarks/dynamic_sweep.py:183-190 (_scaled_specs): each rate times
    its trace-mean scale, so violations are judged against what the trace
    offered."""
    return {s.name: dataclasses.replace(s, rate_rps=s.rate_rps * tr.mean_scale(s.name,
                                                                           horizon_ms))
            for s in specs}


def compare_edits(label, ref, got):
    """Two PlanEdit lists field for field: strings and counts equal, floats
    within PLANNER_TOL.  Returns the count of edits bit-identical to numpy's."""
    assert len(got) == len(ref), f"{label}: {len(got)} edits against numpy's {len(ref)}"
    same = 0
    for a, b in zip(ref, got):
        exact = True
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, float):
                np.testing.assert_allclose(y, x, err_msg=f"{label}: {a} {f.name}",
                                           **PLANNER_TOL)
                exact &= x == y
            else:
                assert x == y, f"{label}: {a} against numpy's {b} ({f.name})"
        same += exact
    return same


def controlled_run(dev, backend, plan, ctx, horizon_s, cfg_kw=None, telemetry=None,
                   record=None, **sim_kw):
    """One closed-loop simulate_full of ``plan`` with a fresh Controller whose
    planner (and the simulator's tables) run on ``backend``: torch on the card,
    or the numpy oracle.  Every launch count is read over this run alone:
    on torch one alloc_all launch per PlanState._place and one tables launch
    per table chunk, and none on numpy; a same-device resize (Alg. 2 against
    its own device, pmv.alloc_gpus_vec) runs on the host and launches
    nothing.  ``record``, a dict, receives the PlanState and arguments of the
    last placement.  Returns (controller, result, wall s, counts)."""
    from repro_torch.core import perf_model_vec as pmv
    from repro_torch.core.types import PlannerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import controller, simulator
    from repro_torch.serving.workload import models
    on_card = backend == "torch"
    config = PlannerConfig(backend=backend, batch="joint",
                           device=str(dev) if on_card else None)
    ctl = controller.Controller(plan, ctx.profiles, ctx.hw, config=config,
                                cfg=controller.ControllerConfig(**(cfg_kw or {})),
                                telemetry=telemetry)
    seen = {} if record is None else {
        "place": lambda state, *a: record.update(state=state, args=a)}
    targets = {"place": (controller.PlanState, "_place"),
               "same_device": (pmv, "alloc_gpus_vec"),
               "chunk": (simulator, "_build_tables_chunk"),
               "build": (simulator, "_build_tables_bulk")}
    mods = models()
    with Spy(targets, seen=seen) as spy:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = simulator.simulate_full(
            plan, mods, ctx.hw, duration_s=horizon_s, seed=CONTROL_SEED, adjust_fn=ctl,
            adjust_scope="cluster", adjust_period_s=1.0, backend=backend,
            device=str(dev) if on_card else None, telemetry=telemetry, **sim_kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    calls = spy.calls
    want = {k: 0 for k in launches}
    if on_card:
        want.update(alloc_all=calls["place"], tables=calls["chunk"])
    assert launches == want, (backend, launches, want)
    counts = {"alloc_all_launches": launches["alloc_all"],
              "tables_launches": launches["tables"], "placements": calls["place"],
              "same_device_resizes": calls["same_device"],
              "table_chunks": calls["chunk"], "table_rebuilds": calls["build"] - 1,
              "placement_s": spy.seconds["place"],
              "same_device_s": spy.seconds["same_device"]}
    return ctl, res, wall, counts


def scenario_pair(dev, name, specs, plan, ctx, horizon_s, cfg_kw=None, record=None):
    """One scenario on both backends, torch first: identical edits (floats
    within PLANNER_TOL), admission log and counters, reconfigurations,
    violations against the trace-scaled specs, and final plan."""
    horizon_ms = horizon_s * 1000.0
    tr, poisson = control_trace(name, [s.name for s in specs], horizon_ms, CONTROL_SEED)
    kw = dict(trace=tr, poisson=poisson)
    runs = {b: controlled_run(dev, b, plan, ctx, horizon_s, cfg_kw,
                              record=record if b == "torch" else None, **kw)
            for b in ("torch", "numpy")}
    (ct, rt, wt, nt), (cn, rn, wn, nn) = runs["torch"], runs["numpy"]
    label = f"controller {name} m={len(specs)}"
    same = compare_edits(label, cn.edits, ct.edits)
    assert ct.reconciler.admission_log == cn.reconciler.admission_log, label
    assert ct.overload_stats() == cn.overload_stats(), label
    assert rt.stats["n_reconfigs"] == rn.stats["n_reconfigs"], label
    sb = scaled_specs(specs, tr, horizon_ms)
    viol = rn.violations(sb)
    assert rt.violations(sb) == viol, label
    assert plan_key(ct.plan) == plan_key(cn.plan), label
    out = {"edits": len(cn.edits), "edits_bit_identical": same,
           "n_reconfigs": rn.stats["n_reconfigs"], "violations": len(viol),
           "devices_final": cn.plan.n_gpus, "overload_stats": cn.overload_stats(),
           "wall_s": {"torch": wt, "numpy": wn},
           "reconfig_latency_ms": {"torch": rt.stats["reconfig_latency_ms"],
                                   "numpy": rn.stats["reconfig_latency_ms"]},
           "placement_s": {"torch": nt["placement_s"], "numpy": nn["placement_s"]},
           "same_device_s": {"torch": nt["same_device_s"], "numpy": nn["same_device_s"]},
           **{k: v for k, v in nt.items() if not k.endswith("_s")}}
    if name == "no_drift":
        for ctl, res in ((ct, rt), (cn, rn)):
            assert ctl.edits == [] and res.stats["n_reconfigs"] == 0, label
            assert ctl.plan is plan, f"{label}: the plan was replaced"
    else:
        assert rn.stats["n_reconfigs"] > 0, label
    log(f"controller: {name} (m={len(specs)}, {horizon_s} s): torch and numpy agree: "
        f"{out['edits']} edits ({same} bit-identical), {out['n_reconfigs']} reconfigurations, "
        f"{out['violations']} violations, {nt['alloc_all_launches']} alloc_all launches for "
        f"{nt['placements']} placements, none for {nt['same_device_resizes']} same-device "
        f"resizes on the host, {nt['tables_launches']} tables launches "
        f"({nt['table_rebuilds']} rebuilds); wall s torch {wt:.3f} numpy {wn:.3f}; "
        f"controller ms torch {rt.stats['reconfig_latency_ms']:.1f} numpy "
        f"{rn.stats['reconfig_latency_ms']:.1f}")
    return out


def spike_fixture_run(dev, specs, plan, ctx):
    """tests/test_spike_fixture.py's run on the card: m = 100, 6 s, Poisson,
    a 2.5x step at 2.4 s for 1.2 s, ControllerConfig(forecast=True),
    Telemetry(retention=600), the torch backend; its predictive events must
    hash to the pinned digest."""
    import hashlib
    from repro_torch.serving import telemetry, traces
    tr = traces.step_spike([s.name for s in specs], 6000.0, at_ms=2400.0,
                           duration_ms=1200.0, scale=2.5)
    tel = telemetry.Telemetry(retention=600)
    _, _, wall, counts = controlled_run(dev, "torch", plan, ctx, 6.0, {"forecast": True},
                                        telemetry=tel, trace=tr, poisson=True)
    pred = [e.to_dict() for e in tel.events
            if e.kind in ("forecast", "shadow_arm", "shadow_disarm")]
    sig = "|".join(f"{e['t_s']}:{e['kind']}:{e['workload']}:{e['replicas']}" for e in pred)
    digest = hashlib.sha256(sig.encode()).hexdigest()
    kinds = {k: sum(e["kind"] == k for e in pred) for k in SPIKE_EVENTS}
    out = {"sha256": digest, "events": kinds,
           "reconfig_events": tel.counters.get("reconfig_events"), "wall_s": wall, **counts}
    assert digest == SPIKE_SEQUENCE_SHA256 and kinds == SPIKE_EVENTS \
        and out["reconfig_events"] == SPIKE_RECONFIGS, out
    log(f"controller: forecast spike run reproduces tests/test_spike_fixture.py: {out}")
    return out


def health_pair(dev, ctx):
    """tests/test_overload.py's two health runs on the App study (14 s,
    Poisson, health_readmit_s = 2) on both backends: a permanent 2.5x
    straggler on W3's device is never readmitted, the same device after an
    outage that ends is readmitted by the canary probe; identical edits."""
    from repro_torch.core import provisioner as prov
    from repro_torch.core.types import PlannerConfig
    from repro_torch.serving import faults
    from repro_torch.serving.workload import twelve_workloads
    plan = prov.provision(twelve_workloads(), ctx.profiles, ctx.hw,
                          config=PlannerConfig(device=str(dev)))
    g = next(p.gpu for p in plan.placements if p.workload.name == "W3")
    out = {}
    for kind, fs in (("straggler", faults.FaultSchedule(slow={g: 2.5})),
                     ("outage", faults.FaultSchedule(down={g: [[2000.0, 5000.0]]}))):
        runs = {b: controlled_run(dev, b, plan, ctx, 14.0, {"health_readmit_s": 2.0},
                                  faults=fs, poisson=True) for b in ("torch", "numpy")}
        ct, cn = runs["torch"][0], runs["numpy"][0]
        compare_edits(f"health {kind}", cn.edits, ct.edits)
        for ctl in (ct, cn):
            readmitted = any(e.action == "readmit" and e.workload == f"device:{g}"
                             for e in ctl.edits)
            quarantined = g in ctl.reconciler.quarantined
            assert (quarantined, readmitted) == ((True, False) if kind == "straggler"
                                                 else (False, True)), (kind, ctl.edits)
        out[kind] = {"device": g, "edits": len(ct.edits),
                     "quarantined_final": sorted(ct.reconciler.quarantined),
                     "readmitted": kind == "outage", **runs["torch"][3]}
    log(f"controller: health runs: {out}")
    return out


def launcher_cluster(dev, ctx):
    """`python -m repro_torch.launch.serve --mode cluster --duration 5` through
    its function on the card, against the numpy backend's plan and
    simulation of the same study: the same devices, cost and per-workload
    ok / VIOLATION flags."""
    import contextlib
    import io
    from repro_torch.core import provisioner as prov
    from repro_torch.core.types import PlannerConfig
    from repro_torch.launch import serve
    from repro_torch.serving import simulator
    from repro_torch.serving.workload import models, specs_by_name, twelve_workloads
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.cluster("iGniter", 5.0, False, device=str(dev))
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    head = re.search(r"^devices=(\d+) cost=\$(\S+)/h", text, re.M)
    flags = dict(re.findall(r"^  (W\d+)\s.* (ok|VIOLATION)$", text, re.M))
    plan = prov.provision(twelve_workloads(), ctx.profiles, ctx.hw,
                          config=PlannerConfig(budget="half", backend="numpy"))
    res = simulator.simulate_plan(plan, models(), ctx.hw, duration_s=5.0, shadow=True,
                                  backend="numpy")
    sb = specs_by_name()
    want = {w: "VIOLATION" if (m["p99_ms"] > sb[w].slo_ms or m["rps"] < 0.95 * sb[w].rate_rps)
            else "ok" for w, m in res.per_workload.items()}
    out = {"devices": int(head.group(1)), "cost_per_hour": float(head.group(2)),
           "flags": flags, "wall_s": wall}
    assert out["devices"] == plan.n_gpus and flags == want and len(flags) == 12, (out, want)
    assert f"{plan.cost_per_hour():.2f}" == head.group(2), (out, plan.cost_per_hour())
    log(f"controller: launch.serve --mode cluster on the card: {out['devices']} devices, "
        f"${head.group(2)}/h, flags equal to numpy's ({sum(f == 'ok' for f in flags.values())} "
        f"ok of 12), {wall:.1f} s")
    return out


def control_breakdown(dev, name, specs, plan, ctx):
    """One profiled torch-backend run of scenario ``name``: the device ms of
    the two kernels and the copies, and the card's idle share of the wall
    time."""
    tr, poisson = control_trace(name, [s.name for s in specs], CONTROL_HORIZON_S * 1000.0,
                                CONTROL_SEED)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _, _, wall, counts = controlled_run(dev, "torch", plan, ctx, CONTROL_HORIZON_S,
                                            trace=tr, poisson=poisson)
    out = {"scenario": name, **device_groups(prof, wall, ("alloc_all_kernel", "tables_kernel")),
           "alloc_all_launches": counts["alloc_all_launches"],
           "tables_launches": counts["tables_launches"]}
    log(f"controller: profiled {name} run: {out}")
    return out


def event_ms(fn, iters=200, sleep_cycles=100_000_000):
    """Device ms per call of fn over ``iters`` back-to-back calls, read with
    CUDA events (after phase 7's long profiled run torch.profiler drops the
    records of small kernels: see device_ms).  The card sleeps while the
    host enqueues the calls, so the events time the kernels and the gaps
    between them on the card, not the host's launch rate; the sleep must
    outlast the enqueueing.  Returns (ms per call, host enqueue ms, sleep ms)."""
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(sleep_cycles)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    assert enqueue_ms < 0.8 * sleep_ms, \
        f"event_ms: enqueueing took {enqueue_ms:.2f} ms, the sleep {sleep_ms:.2f} ms"
    return start.elapsed_time(end) / iters, enqueue_ms, sleep_ms


def time_alloc_all_call(dev, record):
    """alloc_all_kernel's device time per call at the last placement of a
    controlled m = 100 run (the controller's typical d and N; CUDA events
    over 200 calls), beside its bound: each input read once and each output
    written once."""
    from repro_torch.core import perf_model_torch as pmt
    from repro_torch.kernels import grant_loop
    cl, args = record["state"].cl, record["args"]
    d, n = cl.d, cl.mask.shape[1]
    packed = torch.from_numpy(pmt.pack(cl, *args)).to(dev)
    ms, enqueue_ms, sleep_ms = event_ms(lambda: grant_loop.alloc_all(packed, d, n))
    nbytes = 8 * (grant_loop.pack_size(d, n) + grant_loop.out_size(d, n))
    out = {"d": d, "n": n, "ms": ms, "timer": "cuda events, 200 calls", "bytes": nbytes,
           "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "enqueue_ms": enqueue_ms,
           "sleep_ms": sleep_ms}
    log(f"timing: alloc_all at the controller's last placement (d {d}, N {n}): {ms:.4f} ms "
        f"a call over 200 (bytes bound {out['bound_ms']:.6f} ms; enqueued in "
        f"{enqueue_ms:.2f} ms behind a {sleep_ms:.2f} ms sleep)")
    return out


def run_controller(dev):
    """The closed loop on the card: dynamic_sweep's five scenarios on
    synthetic_workloads(100, 0) (tpu-v5e), each with a fresh Controller on
    backend="torch" on the card and again on "numpy"; the spike fixture's
    forecast run; the two health runs; then the diurnal run's timing (median
    of 3 in turns), alloc_all's device time at the controller's shapes, the
    m = 1000 diurnal run on both backends, one profiled run's idle share,
    and the launcher's cluster mode."""
    from repro_torch.core import provisioner as prov
    from repro_torch.core.experiments import fitted_context
    from repro_torch.core.types import PlannerConfig
    from repro_torch.serving.workload import synthetic_workloads
    ctx = fitted_context("tpu-v5e")
    specs = synthetic_workloads(CONTROL_M, CONTROL_SEED)
    plan = prov.provision(specs, ctx.profiles, ctx.hw, config=PlannerConfig(device=str(dev)))
    assert plan_key(plan) == plan_key(prov.provision(
        specs, ctx.profiles, ctx.hw, config=PlannerConfig(backend="numpy")))
    record = {}
    scenarios = {}
    for name in CONTROL_SCENARIOS:
        s, p, cfg_kw = specs, plan, None
        if name == "overload":
            s, p = overload_fleet(specs, ctx, PlannerConfig(device=str(dev)))
            cfg_kw = {"max_devices": p.n_gpus, "headroom": 0.35}
        scenarios[name] = scenario_pair(dev, name, s, p, ctx, CONTROL_HORIZON_S, cfg_kw,
                                        record=record if name == "diurnal" else None)
    assert sum(sc["alloc_all_launches"] for sc in scenarios.values()) > 0, \
        "no controlled run launched alloc_all"
    assert all(sc["tables_launches"] > 0 for sc in scenarios.values()), scenarios
    spike = spike_fixture_run(dev, specs, plan, ctx)
    health = health_pair(dev, ctx)
    alloc_call = time_alloc_all_call(dev, record)

    # the diurnal run's timing: two more runs a backend, in turns
    d0 = scenarios["diurnal"]
    walls = {b: [d0["wall_s"][b]] for b in ("torch", "numpy")}
    ctl_ms = {b: [d0["reconfig_latency_ms"][b]] for b in walls}
    tr, _ = control_trace("diurnal", [s.name for s in specs], CONTROL_HORIZON_S * 1000.0,
                          CONTROL_SEED)
    for _ in range(2):
        for b in walls:
            _, res, wall, _ = controlled_run(dev, b, plan, ctx, CONTROL_HORIZON_S, trace=tr)
            assert res.stats["n_reconfigs"] == d0["n_reconfigs"], b
            walls[b].append(wall)
            ctl_ms[b].append(res.stats["reconfig_latency_ms"])
    timing = {"wall_s": walls, "reconfig_latency_ms": ctl_ms,
              "wall_s_median": {b: float(np.median(w)) for b, w in walls.items()},
              "reconfig_latency_ms_median": {b: float(np.median(w))
                                             for b, w in ctl_ms.items()}}
    log(f"controller: diurnal m={CONTROL_M} timing: {timing}")

    # the Sec. 5.5 overhead run: m = 1000 diurnal, one run a backend
    specs_k = synthetic_workloads(1000, CONTROL_SEED)
    plan_k = prov.provision(specs_k, ctx.profiles, ctx.hw, config=PlannerConfig(device=str(dev)))
    m1000 = scenario_pair(dev, "diurnal", specs_k, plan_k, ctx, CONTROL_M1000_HORIZON_S)
    m1000["devices"] = plan_k.n_gpus
    profiled = control_breakdown(dev, "diurnal", specs, plan, ctx)
    launcher = launcher_cluster(dev, ctx)
    stats = {"m": CONTROL_M, "seed": CONTROL_SEED, "horizon_s": CONTROL_HORIZON_S,
             "devices": plan.n_gpus, "scenarios": scenarios, "spike_fixture": spike,
             "health": health, "diurnal_timing": timing, "alloc_all_call": alloc_call,
             "m1000_diurnal": {"horizon_s": CONTROL_M1000_HORIZON_S, **m1000},
             "profiled": profiled, "launcher_cluster": launcher}
    return stats

# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_STEP = 4, 512, 10, 5
# qwen3-4b at serving's depth cut: 1.59 G params, so float32 params, grads
# and two moments take 25 GB (full depth's 4.4 G would take 70 GB)
TRAIN_MAIN = ("qwen3-4b", 8)
# rwkv6-1.6b 4 of 24 layers, zamba2-2.7b 6 of 54 (one shared-attention group)
TRAIN_RECURRENT = (("rwkv6-1.6b", 4), ("zamba2-2.7b", 6))
TRAIN_RECURRENT_STEPS = 3
TRAIN_PROFILE_ATTEMPTS = 3
TRAIN_SMALL = ("qwen3-4b", "rwkv6-1.6b", "zamba2-2.7b", "mixtral-8x22b", "whisper-large-v3",
               "qwen2-vl-7b")
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}    # of max|g|, card against CPU
TRAIN_DIR = PORT_TREE.parents[1] / "build" / "train_ckpt"   # git-ignored, removed after
# record_function ranges of the port's step (training/loop.py, the kernels'
# autograd wrappers, layers._ChunkedCrossEntropy) -> device-time group
TRAIN_RANGES = {"flash_attention.backward": "attention_backward",
                "rwkv6_scan.backward": "scan_backward", "ssd_scan.backward": "scan_backward",
                "cross_entropy.forward": "cross_entropy",
                "cross_entropy.backward": "cross_entropy",
                "train.optimizer": "optimizer"}
TRAIN_GROUPS = ("matmul", "flash_forward", "attention_backward", "scan_forward",
                "scan_backward", "cross_entropy", "optimizer", "other")


def grads_of(fn, inputs, weights=None, rng=None):
    """Outputs of fn on inputs that require grad and the gradients of the
    random-weighted sum of its outputs (weights drawn from rng when not
    given); also the weights, to repeat the sum on another device."""
    ins = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if weights is None:
        weights = [rand(rng, tuple(o.shape), torch.float32, "cpu") for o in outs]
    loss = sum((o.float() * w.to(o.device)).sum() for o, w in zip(outs, weights))
    return outs, torch.autograd.grad(loss, ins, retain_graph=True), weights, (loss, ins)


def check_train_function(dev, rng, name, fn, recompute, inputs, label):
    """One kernel's autograd wrapper on the card: the forward launches the
    kernel once and the backward launches none; every gradient equals the
    CPU path's within GRAD_TOL of its max.  The CPU path's gradients are
    autograd's through ``recompute`` on the CPU: its backward differentiates
    exactly that, and its forward (the plain version, phase 3's yardstick)
    leaves them as they are, so it is not run.  Returns the row and, for
    timing, the card's inputs and graph."""
    from repro_torch.kernels import ops
    dtype = inputs[0].dtype
    ops.reset_launch_counts()
    outs, grads, weights, graph = grads_of(fn, inputs, rng=rng)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    assert counts == {name: 1}, f"{name} {label}: launches over forward + backward {counts}"
    _, want, _, _ = grads_of(recompute, [t.cpu() for t in inputs], weights)
    errs = []
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == w.dtype == inputs[i].dtype and bool(torch.isfinite(g).all()), (name, label, i)
        errs.append(rel_err(g.cpu(), w))
    worst = max(errs)
    log(f"train: {name} {label} {str(dtype)[6:]}: one launch, none in the backward; "
        f"gradients vs CPU rel. err {worst:.3g} (limit {GRAD_TOL[dtype]})")
    assert worst <= GRAD_TOL[dtype], (name, label, errs)
    return {"name": name, "shape": label, "dtype": str(dtype)[6:], "grad_rel_err": worst}, graph


def train_event_ms(fn, iters=10):
    """ms per call of fn over ``iters`` calls back to back, read with CUDA
    events: the card's time and any gap the host leaves it (a recompute
    backward launches hundreds of small kernels, and torch.profiler drops
    records after runs that large: see device_ms)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_backward(row, graph, forward):
    """ms per call of one backward of the wrapper's graph (the recompute
    and its gradient, and the weighted sum's) and of its forward alone."""
    loss, ins = graph
    row["backward_ms"] = train_event_ms(lambda: torch.autograd.grad(loss, ins, retain_graph=True))
    with torch.no_grad():
        row["forward_ms"] = train_event_ms(forward)
    return row


def sdpa_train_times(q, k, v, causal):
    """SDPA's efficient backend on K/V expanded to every query head, the
    attention rows' yardstick: forward + backward, and backward alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H, KV = q.shape[2], k.shape[2]
    qt = q.detach().transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.detach().repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    go = torch.randn_like(qt)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        both = train_event_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), (qt, kt, vt), go))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        bwd = train_event_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True))
    return {"library_fwd_bwd_ms": both, "library_bwd_ms": bwd, "library": SDPA_EFFICIENT}


def check_train_functions(dev, rng):
    """Phase 9a: each kernel's autograd wrapper at the training shapes,
    against the CPU path, and the backward's device time beside SDPA's."""
    from repro_torch.models import attention as A
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as M
    rows = []
    B, S = TRAIN_BATCH, TRAIN_SEQ
    wh = model_configs()["whisper-large-v3"]
    flash_cases = [((B, S, S, 32, 8, 128), True, dt) for dt in (torch.bfloat16, torch.float32)]
    flash_cases += [((B, S, wh.encoder_seq_len, wh.n_heads, wh.n_kv_heads, wh.hd), False, torch.float32),
                    ((1, 4100, 4100, 4, 2, 128), True, torch.float32)]   # kv-blockwise backward
    for (b, s, skv, H, KV, hd), causal, dt in flash_cases:
        q = rand(rng, (b, s, H, hd), dt, dev)
        k, v = rand(rng, (b, skv, KV, hd), dt, dev), rand(rng, (b, skv, KV, hd), dt, dev)
        label = f"({b}, {s} q / {skv} kv, {H}/{KV}, {hd}){'' if causal else ' unmasked'}"
        full = A.full_attention if max(s, skv) <= A.FULL_MAX else A.kv_blockwise_attention
        pos = lambda n: torch.arange(n)[None].expand(b, n)
        row, graph = check_train_function(
            dev, rng, "flash_attention",
            lambda q_, k_, v_: A.flash_attention(q_, k_, v_, causal=causal),
            lambda q_, k_, v_: full(q_, k_, v_, q_positions=pos(s), kv_positions=pos(skv),
                                    causal=causal, window=None), (q, k, v), label)
        time_backward(row, graph, lambda: A.flash_attention(q, k, v, causal=causal))
        row.update(sdpa_train_times(q, k, v, causal))
        rows.append(row)
        del graph
    Br, Sr, Hr, hdr = RWKV_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        r, k, v, logw, u = rwkv_inputs(rng, Br, Sr, Hr, hdr, dt, dev)
        s0 = 0.1 * rand(rng, (Br, Hr, hdr, hdr), torch.float32, dev)
        row, graph = check_train_function(
            dev, rng, "rwkv6_scan", lambda *a: R.wkv(*a[:5], s0=a[5]),
            lambda *a: (lambda y, st: (y.to(a[0].dtype), st))(*R.wkv_chunked(*a[:5], s0=a[5])),
            (r, k, v, logw, u, s0), f"{RWKV_SHAPE} from a state")
        time_backward(row, graph, lambda: R.wkv(r, k, v, logw, u, s0=s0))
        rows.append({**row, "library_fwd_bwd_ms": None, "library_bwd_ms": None})
        del graph
    Bs, Ss, Hs, hds, N = SSD_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        xh = rand(rng, (Bs, Ss, Hs, hds), dt, dev)
        buf = 0.5 * rand(rng, (Bs, Ss, 2 * N), torch.float32, dev).to(dt)
        Bm, Cm = buf[..., :N], buf[..., N:]
        dt_ = torch.rand((Bs, Ss, Hs), device=dev) * 0.1
        dA = -dt_ * torch.exp(0.5 * rand(rng, (Bs, Ss, Hs), torch.float32, dev))
        h0 = 0.1 * rand(rng, (Bs, Hs, hds, N), torch.float32, dev)
        row, graph = check_train_function(
            dev, rng, "ssd_scan", lambda x, b_, c_, d_, a_, h_: M.ssd(x, b_, c_, d_, a_, h0=h_),
            lambda x, b_, c_, d_, a_, h_: (lambda y, st: (y.to(x.dtype), st))(
                *M.ssd_chunked(x, b_, c_, d_, a_, h0=h_)),
            (xh, Bm, Cm, dt_, dA, h0), f"{SSD_SHAPE} group-form B, C, from a state")
        time_backward(row, graph, lambda: M.ssd(xh, Bm, Cm, dt_, dA, h0=h0))
        rows.append({**row, "library_fwd_bwd_ms": None, "library_bwd_ms": None})
        del graph
    for row in rows:
        lib = row["library_fwd_bwd_ms"]
        log(f"train: {row['name']} {row['shape']} {row['dtype']}: forward {row['forward_ms']:.4f} ms, "
            f"backward (recompute) {row['backward_ms']:.4f} ms"
            + ("" if lib is None else f"; SDPA efficient forward + backward {lib:.4f}, "
               f"backward {row['library_bwd_ms']:.4f}"))
    return rows


def train_step_groups(prof):
    """Device ms of one profiled training step by group: a kernel inside
    one of the port's ranges (TRAIN_RANGES, found as device-side
    annotations) counts there, any other by its name."""
    cuda = torch.autograd.DeviceType.CUDA
    annotations = set(TRAIN_RANGES) | {"train.forward_backward"}
    events = [e for e in prof.events() if e.device_type == cuda]
    windows = [(e.time_range.start, e.time_range.end, TRAIN_RANGES[e.name])
               for e in events if e.name in TRAIN_RANGES]
    groups, other = dict.fromkeys(TRAIN_GROUPS, 0.0), {}
    for e in events:
        if e.name in annotations:
            continue
        group = next((g for s, t, g in windows if s <= e.time_range.start < t), None)
        name = e.name.lower()
        if group is None:
            if "flash_attn_kernel" in name:
                group = "flash_forward"
            elif "scan_kernel" in name:
                group = "scan_forward"
            elif any(k in name for k in ("gemm", "gemv", "cutlass", "nvjet")):
                group = "matmul"      # cuBLAS's bf16 kernels on sm_90 are nvjet_*
            else:
                group = "other"
                other[e.name[:60]] = other.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
        groups[group] += e.time_range.elapsed_us() / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:5])
    return groups, top


def param_grads(model, params, batch, dtype, remat):
    """The loss and every float32 leaf's gradient, as the step takes them,
    with the kernels' launches over the forward and over the whole."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    ops.reset_launch_counts()
    loss = model.loss(T.cast_params(tree_unflatten(params, leaves), dtype), batch, remat=remat)
    forward = ops.launch_counts()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    return loss.detach(), grads, forward, ops.launch_counts()


def check_leaf_grads(arch, grads):
    """Every parameter leaf's gradient is finite and not all zero (a kernel
    call without a backward would leave everything upstream of it zero)."""
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    assert not bad, f"{arch}: leaves {bad} of {len(grads)} have a non-finite or zero gradient"


def train_launches(cfg):
    """Kernel launches of a training step without remat: flash once an
    attention block (zamba2: once a shared-attention group), a scan once a
    recurrent block, none in the backward."""
    kind = cfg.pattern[0]
    if kind == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}
    if kind == "mamba2":
        return {"ssd_scan": cfg.n_layers, "flash_attention": cfg.n_layers // cfg.shared_attn_every}
    return {"flash_attention": cfg.n_layers}


def train_run(dev, arch, layers, steps, ckpt_step=None, remat_check=False):
    """``steps`` steps of ``arch`` at full width (``layers`` deep) as
    loop.train takes them (its AdamW, the pipeline's batches, the compute
    cast to cfg.dtype, remat off), one step at a time through
    loop.make_step: the kernels' launches a step, CUDA-event step times,
    peak memory; the first step's gradients checked leaf by leaf; one more
    step profiled (device ms by group); with ``remat_check`` (an attention
    model) the launches with remat."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.models.zoo import build_model
    from repro_torch.training import checkpoint, loop
    from repro_torch.training.optimizer import AdamW
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).replace(n_layers=layers)
    dtype = loop.compute_dtype(cfg)
    per_step = train_launches(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    opt = AdamW(lr=1e-3, warmup_steps=20, total_steps=steps, weight_decay=0.01)
    params = model.init(0)
    state = opt.init(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    data = make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [loop.to_device(next(data), dev) for _ in range(steps)]
    log(f"train: {arch} full width ({layers} layers, {n_params / 1e9:.3f} B params, "
        f"compute {str(dtype)[6:]}, float32 master params and moments); init "
        f"{time.perf_counter() - t0:.1f} s")
    _, grads, fwd, whole = param_grads(model, params, batches[0], dtype, remat=False)
    check_leaf_grads(arch, grads)
    del grads
    assert fwd == whole and {k: n for k, n in fwd.items() if n} == per_step, (arch, fwd, whole)
    stats = {"arch": arch, "layers": layers, "params": n_params, "batch": TRAIN_BATCH,
             "seq": TRAIN_SEQ, "compute_dtype": str(dtype)[6:], "steps": steps,
             "launches_per_step": per_step}
    if remat_check:     # each block's forward runs again in the backward
        _, grads, fwd, whole = param_grads(model, params, batches[0], dtype, remat=True)
        del grads
        key = "flash_attention"
        assert fwd[key] == per_step[key] and whole[key] == 2 * per_step[key], (arch, fwd, whole)
        stats["remat_launches_per_step"] = whole[key]
    step = loop.make_step(model, opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        ops.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, loss = step(params, state, batch)
        e1.record()
        losses.append(float(loss))
        step_ms.append(e0.elapsed_time(e1))
        got = {k: n for k, n in ops.launch_counts().items() if n}
        assert got == per_step, (arch, i + 1, got, per_step)
        if ckpt_step == i + 1:
            t = time.perf_counter()
            checkpoint.save(str(TRAIN_DIR), i + 1, (params, state))
            stats["checkpoint_save_s"] = time.perf_counter() - t
    assert all(np.isfinite(losses)), losses
    stats["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    timed = step_ms[1:] if steps > 2 else step_ms
    stats.update(losses=losses, step_ms=step_ms, median_step_ms=float(np.median(timed)),
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (float(np.median(timed)) / 1e3))
    # one more step, profiled (its result is dropped); each group the step
    # runs must show device time.  The profiler loses a kernel's record
    # now and then (see device_ms; zamba2-2.7b's step has one flash
    # launch), so a profile missing a group is taken again, up to
    # TRAIN_PROFILE_ATTEMPTS times
    want = ["cross_entropy", "optimizer", "matmul"]
    if "flash_attention" in per_step:
        want += ["flash_forward", "attention_backward"]
    if "rwkv6_scan" in per_step or "ssd_scan" in per_step:
        want += ["scan_forward", "scan_backward"]
    for attempt in range(1, TRAIN_PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            step(params, state, batches[-1])
            torch.cuda.synchronize()
        groups, top_other = train_step_groups(prof)
        missing = [g for g in want if not groups[g] > 0]
        if not missing:
            break
        log(f"train: {arch} profile {attempt} shows no device time for {missing}")
    assert not missing, (missing, groups)
    busy = sum(groups.values())
    stats["profile"] = {"device_ms": groups, "busy_ms": busy, "other_top_ms": top_other,
                        "idle_share": max(0.0, 1.0 - busy / stats["median_step_ms"]),
                        "attempts": attempt}
    log(f"train: {arch} profiled step, device ms {({k: round(v, 3) for k, v in groups.items()})}, "
        f"idle share {stats['profile']['idle_share']:.3f}")
    log(f"train: {arch}: {steps} steps, losses {[round(x, 4) for x in losses]}, median step "
        f"{stats['median_step_ms']:.2f} ms ({stats['tokens_per_s']:.0f} tokens/s), peak "
        f"{stats['peak_memory_gib']:.2f} GiB, launches a step {per_step}")
    del params, state, batches, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def check_resume(dev, stats):
    """loop.train from the step-TRAIN_CKPT_STEP checkpoint (a fresh model,
    restored; the pipeline skipped to its batch) must give the
    uninterrupted run's later losses within 1e-6 relative."""
    from repro_torch.configs import get_config
    from repro_torch.training import loop
    arch, layers = TRAIN_MAIN
    t = time.perf_counter()
    logged = []
    report = loop.train(get_config(arch).replace(n_layers=layers), steps=TRAIN_STEPS,
                        batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, ckpt_dir=str(TRAIN_DIR),
                        ckpt_every=TRAIN_STEPS + 1, log_every=TRAIN_STEPS + 1,
                        log_fn=logged.append, device=dev)
    shutil.rmtree(TRAIN_DIR)
    want = stats["losses"][TRAIN_CKPT_STEP:]
    rel = max(abs(a / b - 1) for a, b in zip(report.losses, want))
    assert logged == [f"restored checkpoint at step {TRAIN_CKPT_STEP}"], logged
    assert len(report.losses) == len(want) and rel <= 1e-6, (report.losses, want)
    log(f"train: loop.train restored at step {TRAIN_CKPT_STEP} reproduces steps "
        f"{TRAIN_CKPT_STEP + 1}-{TRAIN_STEPS} (rel. err {rel:.3g}) in "
        f"{time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"resumed_losses": report.losses, "resume_rel_err": rel}


def check_train_small(dev, arch):
    """A reduced ``arch`` (float32) on the card against the same weights on
    the CPU: the loss within 1e-5 relative and every gradient leaf within
    max(1e-4, twice its noise floor) of its max, the floor being how far
    the CPU gradient moves under a 1e-7 relative change of every weight,
    capped as tests/test_torch_train_grads.py caps it (1e-3 for
    rwkv6-1.6b, whose group norm sees near-zero variances at t = 0, 2e-5
    for the others), so a port fault cannot widen its own bound.  A key
    bias (``bk``) of a model without rotary positions (whisper's) has an
    exact gradient of zero, since softmax does not see a shift of every
    score, and holds only rounding: its gradient, on either device, and
    their difference stay within 1e-4 of the model's largest gradient
    (rotated, as in qwen2-vl-7b, the bias moves each score by another
    amount and its leaf is checked like any other).  An MoE model routes
    every token to the CPU's experts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models.zoo import build_model
    from repro_torch.training import loop
    from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten
    cfg = get_config(arch)
    cfg = reduced(cfg, layers=4 if cfg.shared_attn_every else 2)
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, dev)
    params = cpu_model.init(seed=1)
    batch = next(make_pipeline(cfg, 2, 64, seed=0))
    with record_routes() as routes_cpu:
        loss_cpu, want, _, _ = param_grads(cpu_model, params, loop.to_device(batch, "cpu"),
                                           torch.float32, False)
    with record_routes() as routes_card:
        loss, got, _, _ = param_grads(card_model, tree_map(lambda t: t.to(dev), params),
                                      loop.to_device(batch, dev), torch.float32, False)
    if cfg.is_moe:
        check_routes(arch, routes_cpu, routes_card, cfg.top_k)
    gen = torch.Generator().manual_seed(0)
    moved = [t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)) for t in tree_leaves(params)]
    _, again, _, _ = param_grads(cpu_model, tree_unflatten(params, moved),
                                 loop.to_device(batch, "cpu"), torch.float32, False)
    zero = [name.endswith(".bk") and cfg.rope_theta <= 0 for name in tree_paths(params)]
    got = [g.cpu() for g in got]
    scale = max(float(w.abs().max()) for w in want)
    floors = [rel_err(a, b) for a, b, z in zip(again, want, zero) if not z]
    errs = [rel_err(g, w) for g, w, z in zip(got, want, zero) if not z]
    bad = [(i, e, f) for i, (e, f) in enumerate(zip(errs, floors)) if e > max(1e-4, 2 * f)]
    zero_err = max([max(float(g.abs().max()), float(w.abs().max()), float((g - w).abs().max()))
                    / scale for g, w, z in zip(got, want, zero) if z], default=0.0)
    floor_cap = 1e-3 if arch == "rwkv6-1.6b" else 2e-5
    loss_rel = abs(float(loss) / float(loss_cpu) - 1)
    log(f"train: reduced {arch} card vs CPU: loss rel. err {loss_rel:.3g}, worst gradient "
        f"leaf {max(errs):.3g} (largest noise floor {max(floors):.3g}, cap {floor_cap:g}); "
        f"{sum(zero)} unrotated key-bias leaves within {zero_err:.3g} of the largest "
        f"gradient")
    assert max(floors) < floor_cap, (arch, max(floors), floor_cap)
    assert loss_rel <= 1e-5 and not bad and zero_err <= 1e-4, (arch, loss_rel, bad, zero_err)
    return {"arch": arch, "loss_rel_err": loss_rel, "worst_grad_rel_err": max(errs),
            "largest_noise_floor": max(floors), "zero_grad_leaves": sum(zero),
            "zero_grad_err_of_largest": zero_err}


def run_train(dev):
    """Phase 9: the kernels' autograd wrappers, the main path (qwen3-4b)
    with its checkpoint resumed through loop.train, rwkv6-1.6b and
    zamba2-2.7b at full width, the reduced models against the CPU, and the
    JAX package's short training run's config on the card."""
    from repro_torch.configs import get_config
    from repro_torch.training import loop
    t0 = time.perf_counter()
    if TRAIN_DIR.exists():
        shutil.rmtree(TRAIN_DIR)
    out = {"functions": check_train_functions(dev, np.random.default_rng(41))}
    arch, layers = TRAIN_MAIN
    main = train_run(dev, arch, layers, TRAIN_STEPS, ckpt_step=TRAIN_CKPT_STEP, remat_check=True)
    main.update(check_resume(dev, main))
    out["main"] = main
    out["recurrent"] = [train_run(dev, arch, layers, TRAIN_RECURRENT_STEPS)
                        for arch, layers in TRAIN_RECURRENT]
    out["small"] = [check_train_small(dev, a) for a in TRAIN_SMALL]
    cfg = get_config("qwen3-4b").replace(     # tests/test_data_training.py's config
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512, dtype="float32")
    report = loop.train(cfg, steps=60, batch=8, seq=64, log_every=1000, log_fn=log, device=dev)
    first, last = float(np.mean(report.losses[:10])), float(np.mean(report.losses[-10:]))
    log(f"train: the reference test's 60 steps on the card: loss {first:.4f} -> {last:.4f}")
    assert last < first - 0.3, (first, last)
    out["short_run"] = {"first10": first, "last10": last}
    out["phase_s"] = time.perf_counter() - t0
    log(f"train: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the mesh layer (step builders on a 1x1 mesh, the dry run)
# ---------------------------------------------------------------------------

MESH_TRAIN = ("qwen3-4b", 8)              # phase 9's main model and depth
MESH_ACC = ("mixtral-8x22b", 1)           # bf16 accumulation, int8 moments: one layer
MESH_ACC_SHAPE = (16, 128)                # 16 rows: TRAIN_MICROBATCHES' 16 of one row
MESH_DECODE_STEPS = 3                     # + the prefill's token: 4 generated tokens
MESH_CACHE_TOL = 1e-5                     # of a cache's max, as tests/test_torch_mesh_ranks.py
# the dry run on the fake 16x16 mesh, in a process of its own: (arch, shape,
# layers or None for the full depth); dbrx-132b's 40 layers x 16
# microbatches take minutes, so the phase runs 2 (the full-depth row comes
# from the CLI); qwen3-4b's decode_32k decodes over a cache sharded over its
# slots without gathering it
MESH_DRYRUN = (("qwen3-4b", "train_4k", None), ("dbrx-132b", "train_4k", 2),
               ("qwen3-4b", "decode_32k", None))
DECODE_COLLECTIVE_MAX_S = 5e-3     # the decode row's collective term: no cache gathered
MESH_DIR = PORT_TREE.parents[1] / "build" / "mesh_dryrun"   # git-ignored


def start_dryruns():
    """The dry runs, one subprocess each (a fake process group cannot share
    this process with the phase's real one), started before the phase's
    card work: they use the host only."""
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(PORT_TREE.parent)}
    procs = []
    for arch, shape, layers in MESH_DRYRUN:
        out = MESH_DIR / f"{arch}_{shape}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(out), "--save-hlo-dir", str(MESH_DIR)]
        if layers:
            cmd += ["--layers", str(layers)]
        log_path = MESH_DIR / f"{arch}_{shape}.log"
        procs.append((arch, out, log_path, time.perf_counter(), subprocess.Popen(
            cmd, cwd=PORT_TREE.parents[1], env=env, stdout=open(log_path, "w"),
            stderr=subprocess.STDOUT)))
    return procs


def finish_dryruns(procs, timeout=600):
    """Wait for the dry runs; every record must have status "ok".  A decode
    record's collective term stays under DECODE_COLLECTIVE_MAX_S and is not
    dominant, and its saved ops hold one partial kernel a layer and no
    all-gather whose output has the cache's slot count."""
    from repro_torch.launch.shapes import SHAPES
    records = []
    for arch, out, log_path, t0, proc in procs:
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
        tail = log_path.read_text()[-3000:]
        assert rc == 0 and out.exists(), f"dry run of {arch}: exit {rc}\n{tail}"
        (rec,) = json.loads(out.read_text())
        assert rec["status"] == "ok", rec
        assert rec["mesh_device"] == "cuda", rec       # the card's program, not a CPU mesh's
        rec["wall_s"] = time.perf_counter() - t0
        if rec["shape"].startswith("decode"):
            assert rec["collective_s"] < DECODE_COLLECTIVE_MAX_S, rec
            assert rec["dominant"] != "collective", rec
            ops_path = MESH_DIR / f"{arch}_{rec['shape']}_{rec['mesh']}.ops"
            ops = [json.loads(line) for line in ops_path.open()]
            slots = str(SHAPES[rec["shape"]].seq_len)
            assert not any(slots in o for r in ops if r.get("collective") == "all-gather"
                           for o in r["out"]), f"{ops_path}: the cache is gathered"
            partial = sum(r["op"].startswith("repro.decode_attention_partial") for r in ops)
            assert partial == rec["layers"], (partial, rec["layers"])
            rec["partial_kernels"] = partial
        mem = rec["temp_bytes_per_dev"] + rec["arg_bytes_per_dev"]
        log(f"mesh: dry run {arch} {rec['shape']} {rec['mesh']} {rec['mesh_device']} mesh, torch "
            f"{rec['torch']} ({rec['layers']} layers): "
            f"{mem / 2**30:.2f} GiB a device (args {rec['arg_bytes_per_dev'] / 2**30:.2f}, "
            f"temp {rec['temp_bytes_per_dev'] / 2**30:.2f}), fits_hbm {rec['fits_hbm']}, "
            f"dominant {rec['dominant']} (compute / memory / collective "
            f"{rec['compute_s'] * 1e3:.2f} / {rec['memory_s'] * 1e3:.2f} / "
            f"{rec['collective_s'] * 1e3:.2f} ms), {rec['run_s']:.1f} s")
        records.append(rec)
    return records


def whole(tree):
    """DTensor leaves as whole tensors (host ints kept)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


class GradsOut:
    """An optimizer for a built step that returns the gradients as the new
    params (the step's gradients, compared leaf by leaf)."""

    def init(self, params):
        from repro_torch.training.optimizer import AdamW
        return AdamW().init(params)

    def update(self, grads, state, params):
        return grads, state


class Recording:
    """The step's optimizer, keeping the gradients it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.inner.update(grads, state, params)


def leaf_rel(a, b):
    """max|a - b| / max|b| in float32 (``rel_err`` casts to float64, which
    a full-width leaf of several GB cannot spare)."""
    return float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-30)


def mesh_train(dev, mesh):
    """The train step of qwen3-4b (8 layers, batch 4 x 512) built on the
    mesh: at M = 1 without remat, with the table and its moments sharded
    over its rows (``rows_sharded``), equal to loop.make_step (bf16
    compute, loss and every updated param within 1e-6 relative); at M = 2 the loss
    and every gradient leaf equal M = 1's within 1e-4 of their max (float32
    compute: bf16 rounds a product to 4e-3 of its size, and halving the
    batch changes what it rounds); flash 8 launches a microbatch without
    remat, 16 with it (none in the backward)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    from repro_torch.training import loop
    from repro_torch.training.optimizer import AdamW
    from repro_torch.tree import tree_leaves
    arch, layers = MESH_TRAIN
    cfg = get_config(arch).replace(n_layers=layers)
    shape = InputShape("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    model = build_model(cfg, dev)
    params = model.init(0)
    batch = loop.to_device(next(make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)), dev)
    opt = AdamW(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS, weight_decay=0.01)
    out = {"arch": arch, "layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}

    want_p, _, want_loss = loop.make_step(model, opt)(params, opt.init(params), batch)
    want_p = [t.clone() for t in tree_leaves(want_p)]
    st = steps.make_train_step(arch, mesh, shape=shape, cfg=cfg, remat=False,
                               microbatches=1, opt=opt)
    p, o, b = st.shard(params, opt.init(params), batch)
    args = (rows_sharded(p, mesh), o._replace(mu=rows_sharded(o.mu, mesh),
                                              nu=rows_sharded(o.nu, mesh)), b)
    del p, o, b
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    got_p, got_o, got_loss = st.fn(*args)
    e1.record()
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    assert counts == {"flash_attention": layers}, counts
    got_loss = float(whole(got_loss))
    loss_rel = abs(got_loss / float(want_loss) - 1)
    param_rel = max(leaf_rel(g, w) for g, w in zip(tree_leaves(whole(got_p)), want_p))
    assert loss_rel <= 1e-6 and param_rel <= 1e-6, (loss_rel, param_rel)
    out.update(m1_loss=got_loss, m1_loss_rel=loss_rel, m1_param_rel=param_rel,
               m1_step_ms=e0.elapsed_time(e1), m1_launches=counts)
    log(f"mesh: {arch} train step on the 1x1 mesh, M = 1: loss {got_loss:.6f} (rel. err "
        f"{loss_rel:.3g} against loop.make_step), params rel. err {param_rel:.3g}, "
        f"{e0.elapsed_time(e1):.1f} ms, launches {counts}")
    del args, got_p, got_o, want_p
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    grads = {}
    for M, remat in ((1, False), (2, False), (1, True)):
        st = steps.make_train_step(arch, mesh, shape=shape, cfg=cfg32, remat=remat,
                                   microbatches=M, opt=GradsOut())
        args = st.shard(params, AdamW().init(params), batch)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g, _, loss = st.fn(*args)
        e1.record()
        torch.cuda.synchronize()
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        want = {"flash_attention": layers * M * (2 if remat else 1)}
        assert counts == want, (M, remat, counts, want)
        out[f"f32_m{M}{'_remat' if remat else ''}_step_ms"] = e0.elapsed_time(e1)
        if not remat:
            grads[M] = (float(whole(loss)), [t.clone() for t in tree_leaves(whole(g))])
        del args, g
        gc.collect()
        torch.cuda.empty_cache()
    loss_rel = abs(grads[2][0] / grads[1][0] - 1)
    grad_rel = max(leaf_rel(a, b) for a, b in zip(grads[2][1], grads[1][1]))
    assert loss_rel <= 1e-4 and grad_rel <= 1e-4, (loss_rel, grad_rel)
    out.update(m2_loss_rel=loss_rel, m2_grad_rel=grad_rel,
               flash_launches={"microbatch": layers, "remat_microbatch": 2 * layers})
    log(f"mesh: {arch} M = 2 against M = 1 (float32 compute): loss rel. err {loss_rel:.3g}, "
        f"worst gradient leaf {grad_rel:.3g} of its max; step ms M = 1 "
        f"{out['f32_m1_step_ms']:.1f}, M = 2 {out['f32_m2_step_ms']:.1f}, M = 1 with remat "
        f"{out['f32_m1_remat_step_ms']:.1f}; flash {layers} launches a microbatch, "
        f"{2 * layers} with remat")
    del grads, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_accumulate(dev, mesh):
    """One step of mixtral-8x22b (MESH_ACC's depth) with the builder's
    tables: TRAIN_MICROBATCHES' 16 microbatches accumulated in bf16 against
    the bf16 compute copy (TRAIN_ACC_DTYPE), AdamW with int8 moments
    (TRAIN_OPTIMIZER): the loss, every gradient and every new param finite,
    the large leaves' moments int8."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    from repro_torch.training import loop
    from repro_torch.tree import tree_leaves
    arch, layers = MESH_ACC
    B, S = MESH_ACC_SHAPE
    cfg = get_config(arch).replace(n_layers=layers)
    M = steps.TRAIN_MICROBATCHES[arch]
    assert steps.TRAIN_ACC_DTYPE[arch] == torch.bfloat16
    opt = Recording(steps.TRAIN_OPTIMIZER[arch])
    st = steps.make_train_step(arch, mesh, shape=InputShape("smoke", S, B, "train"), cfg=cfg,
                               opt=opt)
    model = build_model(cfg, dev)
    params = model.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = loop.to_device(next(make_pipeline(cfg, B, S, seed=0)), dev)
    args = st.shard(params, opt.init(params), batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_p, new_o, loss = st.fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(whole(loss))
    grads = tree_leaves(opt.grads)
    assert np.isfinite(loss), loss
    assert all(bool(torch.isfinite(g.to_local()).all()) for g in grads)
    assert all(bool(torch.isfinite(p.to_local()).all()) for p in tree_leaves(new_p))
    acc_dtypes = sorted({str(g.dtype)[6:] for g in grads})
    n_int8 = sum(1 for m in tree_leaves(new_o.mu) if m.dtype == torch.int8)
    assert n_int8 > 0 and "bfloat16" in acc_dtypes, (n_int8, acc_dtypes)
    out = {"arch": arch, "layers": layers, "params": n_params, "batch": B, "seq": S,
           "microbatches": M, "loss": loss, "grad_dtypes": acc_dtypes, "int8_moment_leaves": n_int8,
           "step_s": step_s, "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log(f"mesh: {arch} ({layers} layer, {n_params / 1e9:.2f} B params) one step, {M} "
        f"microbatches of {B // M} x {S} accumulated in bf16, int8 moments on {n_int8} leaves: "
        f"loss {loss:.4f}, every gradient and param finite, gradients {acc_dtypes}, "
        f"{step_s:.1f} s, peak {out['peak_memory_gib']:.1f} GiB")
    del args, new_p, new_o, grads, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def on_model_dim(t, mesh, shard):
    """A DTensor placed over the mesh's "model" dim as ``shard`` says, as
    the step's specs place it where that dim has more than one device
    (``placements`` replicates a dim of one device, so the 1x1 mesh would
    otherwise take the paths of a table whole in its rows and a cache
    whole in its slots)."""
    pl = list(t.placements)
    pl[mesh.mesh_dim_names.index("model")] = shard
    return t.redistribute(mesh, pl)


def rows_sharded(tree, mesh):
    """A params-shaped tree with its embedding table sharded over its rows:
    the lookup and its gradient per vocabulary shard (layers.embed)."""
    from torch.distributed.tensor import Shard
    return {**tree, "embed": {**tree["embed"],
                              "table": on_model_dim(tree["embed"]["table"], mesh, Shard(0))}}


def on_slot_shards(p, c, mesh):
    """The serving arguments with the table sharded over its rows and every
    layer's K and V over its slots (``kv_seq_shard``)."""
    import dataclasses
    from torch.distributed.tensor import Shard
    c = {**c, "layers": [dataclasses.replace(kv, k=on_model_dim(kv.k, mesh, Shard(2)),
                                             v=on_model_dim(kv.v, mesh, Shard(2)))
                         for kv in c["layers"]]}
    return rows_sharded(p, mesh), c


def mesh_serve(dev, mesh):
    """The prefill and decode steps of qwen3-4b (8 layers) built on the mesh
    (``build_step``), with the serving steps' bf16 params, twice: as they
    place the cache on the 1x1 mesh (whole in its slots) and with the cache
    sharded over its slots (``on_slot_shards``).  Each run's
    MESH_DECODE_STEPS + 1 greedy tokens equal Model.prefill /
    decode_step's on the same params; the slot-sharded run's caches too,
    within MESH_CACHE_TOL of each one's max.  Launches: flash once a layer in each prefill;
    decode_attention once a layer a decode step on the whole cache, the
    partial kernel (each rank's slots, ``combine_partials`` over the slots'
    mesh dim) in its place on the sharded one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_map
    arch, layers = MESH_TRAIN
    cfg = get_config(arch).replace(n_layers=layers)
    slots = PROMPT + MESH_DECODE_STEPS + 1
    pre = steps.build_step(arch, "prefill_32k", mesh,
                           shape=InputShape("smoke", slots, BATCH, "prefill"), cfg=cfg)
    dec = steps.build_step(arch, "decode_32k", mesh,
                           shape=InputShape("smoke", slots, BATCH, "decode"), cfg=cfg)
    model = build_model(cfg, dev)
    params = tree_map(lambda t, a: t.to(a.dtype), model.init(0), pre.abstract_args[0])
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                           generator=gen, device=dev)

    def greedy(lg):
        return lg.argmax(-1).to(torch.int32)[:, None]

    cache = model.init_cache(BATCH, slots, dtype=torch.bfloat16)
    lg, cache = model.prefill(params, {"tokens": prompt}, cache)
    want = [greedy(lg)]
    for _ in range(MESH_DECODE_STEPS):
        lg, cache = model.decode_step(params, want[-1], cache)
        want.append(greedy(lg[:, -1]))
    out = {"arch": arch, "layers": layers, "batch": BATCH, "prompt": PROMPT}
    for run in ("whole_cache", "slot_sharded"):
        p, b, c = pre.shard(params, {"tokens": prompt}, model.init_cache(BATCH, slots,
                                                                         dtype=torch.bfloat16))
        if run == "slot_sharded":
            p, c = on_slot_shards(p, c, mesh)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lg, c = pre.fn(p, b, c)
        torch.cuda.synchronize()
        pre_counts = {k: n for k, n in ops.launch_counts().items() if n}
        got = [greedy(whole(lg))]
        ops.reset_launch_counts()
        for _ in range(MESH_DECODE_STEPS):
            nxt, c = dec.fn(p, dec.place(1, got[-1]), c)
            got.append(whole(nxt))
        torch.cuda.synchronize()
        dec_counts = {k: n for k, n in ops.launch_counts().items() if n}
        kernel = "decode_attention_partial" if run == "slot_sharded" else "decode_attention"
        assert pre_counts == {"flash_attention": layers}, (run, pre_counts)
        assert dec_counts == {kernel: layers * MESH_DECODE_STEPS}, (run, dec_counts)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        assert same, (run, [t.flatten().tolist() for t in got],
                      [t.flatten().tolist() for t in want])
        stats = {"tokens": [t.flatten().tolist() for t in got],
                 "prefill_launches": pre_counts, "decode_launches": dec_counts}
        msg = ""
        if run == "slot_sharded":
            got_c = whole(c)
            stats["cache_rel_err"] = max(
                leaf_rel(getattr(a, f), getattr(w, f))
                for a, w in zip(got_c["layers"], cache["layers"]) for f in ("k", "v"))
            assert stats["cache_rel_err"] <= MESH_CACHE_TOL, stats["cache_rel_err"]
            assert all(torch.equal(a.pos, w.pos) for a, w in zip(got_c["layers"],
                                                                  cache["layers"]))
            msg = (f", every layer's K and V within {stats['cache_rel_err']:.3g} of its "
                   f"max")
            del got_c
        log(f"mesh: {arch} prefill + {MESH_DECODE_STEPS} decode steps on the 1x1 mesh, "
            f"{run.replace('_', ' ')} (bf16 params): {len(got)} greedy tokens equal "
            f"Model.prefill / decode_step's{msg}; launches {pre_counts} in the prefill, "
            f"{dec_counts} in the decode steps")
        out[run] = stats
        del p, b, c
    del params, model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_mesh(dev):
    """Phase 10: the step builders on the 1x1 mesh of cuda:0 (a one-rank
    nccl group) and the dry run on the abstract 16x16 mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    t0 = time.perf_counter()
    procs = start_dryruns()
    try:
        mesh = make_smoke_mesh()
        log(f"mesh: {mesh} ({dist.get_backend()}), "
            f"{time.perf_counter() - t0:.1f} s")
        out = {"train": mesh_train(dev, mesh), "accumulate": mesh_accumulate(dev, mesh),
               "serve": mesh_serve(dev, mesh)}
        dist.destroy_process_group()
        out["dryrun"] = finish_dryruns(procs)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
    out["phase_s"] = time.perf_counter() - t0
    log(f"mesh: phase {out['phase_s']:.1f} s")
    return out


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
    cells = benchmark_cells()
    cell_shapes = [(name, kernel, shape) for name, cc in cells.items()
                   for kernel, shape in kernel_shapes(*cc).items()]
    # each such kernel's check (phase 3) and timing (phase 5) at a cell's shape
    cell_fns = {"ssd_scan": (check_ssd_cell, time_ssd), "moe_experts": (check_moe, time_moe)}
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
        errs = {"flash_attention": check_flash(dev, rng, cells),
                "decode_attention": check_decode(dev, rng),
                "rwkv6_scan": check_rwkv(dev, rng), "ssd_scan": check_ssd(dev, rng)}
        cell_errs = [cell_fns[kernel][0](dev, rng, shape) for _, kernel, shape in cell_shapes]
        # the cells' passes, which give check_gemm and time_gemm their shapes
        passes = {name: check_cell_pass(dev, name, *cc) for name, cc in cells.items()}
        errs["gemm"] = check_gemm(dev, rng, passes)
        # the combine of a cache sharded over its slots, as segments on one card
        segments_err = decode_segments(dev, rng)
        for kernel, counts in sass.result().items():
            log(f"sass: every {kernel} instantiation holds {SASS_CHECKS[kernel][2]}: "
                f"{counts}")
    # phase 5 before the slices' and the later phases' large runs: the larger
    # the profiler runs before a timing, the more kernel records it drops
    # (see device_ms)
    kernels = [time_flash(dev, rng), time_decode(dev, rng)]
    kernels.append({**time_decode(dev, rng, partial=True), "segments_max_abs_err": segments_err,
                    "launches_on": "phase 10's decode steps on a cache sharded over its "
                                   "slots (mesh_serve)"})
    for name, timer in (("rwkv6_scan", time_rwkv), ("ssd_scan", time_ssd)):
        kernels.append(timer(dev, rng, errs[name]))
    for k in kernels:
        log_timing(k)
    # the cells' own shapes of the Mamba2 scan and the grouped expert products
    cell_kernels = [{**cell_fns[kernel][1](dev, rng, err, shape), "cell": name}
                    for (name, kernel, shape), err in zip(cell_shapes, cell_errs)]
    # the attention kernels at the other served models' heads: zamba2-2.7b's
    # shared block (head_dim 80, 32 kv heads), mixtral-8x22b's and dbrx-132b's
    # 48 / 8, qwen2-vl-7b's 28 / 4 (G = 7); whisper-large-v3's encoder over its
    # frames and its prompt's cross-attention to them (no mask), its decoder's
    # causal prompt, and its decode step on the self and on the cross cache;
    # deepseek-v2-lite's latent attention at q.k 192 / v 128 (16 heads)
    cfgs = model_configs()
    vl, wh, ds = cfgs["qwen2-vl-7b"], cfgs["whisper-large-v3"], cfgs["deepseek-v2-lite"]
    g7 = (vl.n_heads, vl.n_kv_heads, vl.hd)
    heads, Se = (wh.n_heads, wh.n_kv_heads, wh.hd), wh.encoder_seq_len
    served = [("zamba2-2.7b", time_flash(dev, rng, 32, 32, 80)),
              ("zamba2-2.7b", time_decode(dev, rng, 32, 32, 80)),
              ("mixtral-8x22b / dbrx-132b", time_flash(dev, rng, 48, 8, 128)),
              ("mixtral-8x22b / dbrx-132b", time_decode(dev, rng, 48, 8, 128)),
              ("qwen2-vl-7b", time_flash(dev, rng, *g7)),
              ("qwen2-vl-7b", time_decode(dev, rng, *g7)),
              ("whisper-large-v3", time_flash(dev, rng, *heads, S=Se, causal=False)),
              ("whisper-large-v3", time_flash(dev, rng, *heads, Skv=Se, causal=False)),
              ("whisper-large-v3", time_flash(dev, rng, *heads)),
              ("whisper-large-v3", time_decode(dev, rng, *heads)),
              ("whisper-large-v3", time_decode(dev, rng, *heads, cross_frames=Se)),
              ("deepseek-v2-lite", time_flash(dev, rng, ds.n_heads, ds.n_kv_heads, ds.hd,
                                              hdv=ds.v_head_dim))]
    served = [{**k, "model": model} for model, k in served]
    for k in cell_kernels + served:
        log_timing(k, f"{k['name']} ({k.get('cell') or k['model']}, {k['shape']})")
    # phase 6, the planner
    clusters, planner_err = check_planner(dev, np.random.default_rng(17))
    planner_kernel, planner = run_planner(dev)
    planner_kernel["max_abs_err"] = planner_err
    # phase 7, the simulator
    grids, tables_err = check_tables(dev, np.random.default_rng(29))
    tables_kernel, simulator_stats = run_simulator(dev)
    tables_kernel["max_abs_err"] = tables_err
    # phase 8, the controller
    controller_stats = run_controller(dev)
    # the 3xTF32 products at the benchmark cells' shapes, after every
    # torch.profiler timing (they time by CUDA events, and the runs they make
    # can leave a later profiler run short of records: see device_ms)
    gemm_rows, gemm_cells = time_gemm(dev, rng, errs["gemm"], passes)
    launches, slices = dict.fromkeys(errs, 0), []
    for arch, layers, encoder_layers in MODELS:
        check_small_against_cpu(dev, arch)
        counts, stats = run_slice(dev, arch, layers, encoder_layers)
        launches = {k: n + counts[k] for k, n in launches.items()}
        slices.append(stats)
    # phase 9, training, after the slices
    train = run_train(dev)
    # phase 10, the mesh layer, last
    mesh = run_mesh(dev)
    launches["decode_attention_partial"] = (
        mesh["serve"]["slot_sharded"]["decode_launches"]["decode_attention_partial"])
    kernels = ([{**k, "launches": launches[k["name"]]} for k in kernels]
               + [{**k, "launches": passes[k["cell"]]["launches_a_pass"][k["name"]]}
                  for k in cell_kernels]
               + [{**k, "launches": launches["gemm"], "cell_pass": gemm_cells[k["cell"]]}
                  for k in gemm_rows]
               + served + [planner_kernel, tables_kernel])
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    for stats in slices:
        print(json.dumps({"slice": {**stats, "gpu": smi}}), flush=True)
    for stats in passes.values():
        print(json.dumps({"cell": {**stats, "gpu": smi}}), flush=True)
    print(json.dumps({"planner": {"random_clusters": clusters, **planner, "gpu": smi}}),
          flush=True)
    print(json.dumps({"simulator": {"table_grids": grids, **simulator_stats, "gpu": smi}}),
          flush=True)
    print(json.dumps({"controller": {**controller_stats, "gpu": smi}}), flush=True)
    print(json.dumps({"train": {**train, "gpu": smi}}), flush=True)
    print(json.dumps({"mesh": {**mesh, "gpu": smi}}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
