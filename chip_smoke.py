#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and exits non-zero):
  1. device   -- the card's name and power limit (nvidia-smi)
  2. build    -- nvcc builds the CUDA kernels from src/repro_torch/kernels/csrc
  3. kernels  -- each CUDA kernel against its plain PyTorch version on the
                 card: the shape grid of tests/test_kernels.py in f32 and
                 bf16 (tolerance 2e-5 / 2e-2), a ragged S, rolling slots with
                 a row that has no valid slot, caches cut into one chunk and
                 into chunks of two tiles, and the slice's own shapes; inputs
                 no kernel is built for raise
  4. slice    -- ServingEngine over qwen3-4b at full width and depth (f32,
                 random weights from a torch.Generator on the card) answers
                 16 requests in 4 pumps; the kernels' launch counters are read
                 over those pumps alone; the first decode step's logits must
                 equal a prefill over prompt + that token (rel. err <= 1e-3);
                 a reduced qwen3-4b on the card must match the same model's
                 plain CPU path (rel. err <= 1e-4); one prefill and one
                 decode step alone, on the host clock and under torch.profiler
  5. timing   -- device time (torch.profiler) of each kernel, its plain
                 version and one PyTorch library call (scaled_dot_product_
                 attention, a yardstick the port never calls) at the slice's
                 shapes, beside the least time the card could take (bound_ms)
Prints one {"kernels": [...]} line, one {"slice": {...}} line, and last
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

ARCH, BATCH, PROMPT, DECODE, PUMPS = "qwen3-4b", 4, 512, 4, 4
REL_TOL_FULL, REL_TOL_SMALL = 1e-3, 1e-4


def log(msg):
    print(msg, flush=True)


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
    """(kernel name, device microseconds) for every device event a
    torch.profiler run recorded."""
    out = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            out.append((evt.key, evt.self_cuda_time_total if us is None else us))
    return out


def device_ms(fn, n_inputs, iters=20):
    """Mean device time per call of fn(i), cycling over n_inputs input sets:
    the summed durations of the kernels it launched, read with
    torch.profiler, so host time between small launches does not count."""
    for i in range(3):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        for i in range(iters):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    us = sum(t for _, t in device_kernels_us(prof))
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    n = 0
    # test_kernels.py's grid, a ragged S, one chunk (S=48) and chunks of two tiles (S=2000)
    for S, H, KV, hd in [(512, 4, 2, 64), (1024, 8, 8, 64), (256, 4, 1, 128), (300, 16, 2, 32),
                         (48, 4, 2, 64), (2000, 8, 8, 64)]:
        for dt in (torch.float32, torch.bfloat16):
            for window in (None, 128):
                B = 2
                q = rand(rng, (B, 1, H, hd), dt, dev)
                k, v = rand(rng, (B, S, KV, hd), dt, dev), rand(rng, (B, S, KV, hd), dt, dev)
                qpos = torch.tensor([S // 2, S - 1], dtype=torch.int32, device=dev)
                kvpos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
                out = decode_attention(q, k, v, qpos, kvpos, window=window)
                want = ref.decode_attention_ref(q, k, v, qpos, kvpos, window=window)
                check_close(f"decode {S, H, KV, hd, dt, window}", out, want, TOL[dt])
                n += 1
    # rolling slots: -1 never written; row 1 has no valid slot -> mean(V)
    B, S, H, KV, hd = 2, 128, 2, 2, 64
    q = rand(rng, (B, 1, H, hd), torch.float32, dev)
    k, v = rand(rng, (B, S, KV, hd), torch.float32, dev), rand(rng, (B, S, KV, hd), torch.float32, dev)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    kvpos = torch.stack([torch.where(ar < 100, ar, -1), torch.full_like(ar, -1)])
    qpos = torch.tensor([99, 99], dtype=torch.int32, device=dev)
    out = decode_attention(q, k, v, qpos, kvpos)
    check_close("decode rolling", out, ref.decode_attention_ref(q, k, v, qpos, kvpos), 2e-5)
    check_close("decode no valid slot = mean(V)", out[1, 0],
                v[1].mean(0).repeat_interleave(H // KV, dim=0), 2e-5)
    q, kv = torch.zeros((1, 1, 32, 64), device=dev), torch.zeros((1, 64, 1, 64), device=dev)
    pos = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    expect_refusal("decode_attention 32 query heads per kv head",
                   lambda: decode_attention(q, kv, kv, pos[:, 0], pos))
    # the slice's decode shape: the engine's heads-major cache, read as a view
    err = decode_slice_case(dev, rng)
    log(f"kernels: decode_attention matches its plain version on {n + 3} cases; "
        f"slice-shape max_abs_err {err:.3g}")
    return err


def decode_inputs(dev, rng, n_copies=1):
    """The slice's decode call: q (4,1,32,128), heads-major caches
    (4, 8, 524, 128) passed as (B, S, KV, hd) views, first step after a
    512-token prompt."""
    B, H, KV, hd, S_buf = BATCH, 32, 8, 128, PROMPT + DECODE + 8
    q = rand(rng, (B, 1, H, hd), torch.float32, dev)
    caches = [(rand(rng, (B, KV, S_buf, hd), torch.float32, dev),
               rand(rng, (B, KV, S_buf, hd), torch.float32, dev)) for _ in range(n_copies)]
    slots = torch.arange(S_buf, dtype=torch.int32, device=dev)[None].expand(B, S_buf)
    kvpos = torch.where(slots < PROMPT + 1, slots, -1)
    qpos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    return q, caches, qpos, kvpos


def decode_slice_case(dev, rng):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    q, [(kc, vc)], qpos, kvpos = decode_inputs(dev, rng)
    out = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), qpos, kvpos)
    want = ref.decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2), qpos, kvpos)
    return check_close("decode slice shape", out, want, TOL[torch.float32])


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def run_slice(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=BATCH, prompt_len=PROMPT,
                        decode_tokens=DECODE, seed=0, device=dev)
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"slice: {ARCH} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
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
    want = {"flash_attention": cfg.n_layers * PUMPS,
            "decode_attention": cfg.n_layers * (DECODE - 1) * PUMPS}
    assert launches == want, (launches, want)
    log(f"slice: {len(done)} completions in {PUMPS} pumps, launches {launches}")

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
    for name, t in (("prefill", lg0), ("decode", lg1), ("prefill+1", full)):
        assert t.shape[-1] == cfg.vocab_size and bool(torch.isfinite(t).all()), name
    assert np.array_equal(tok[:, 0].cpu().numpy(), np.stack([c.tokens[0] for c in done[:BATCH]])), \
        "engine's first tokens differ from the model's own prefill"
    rel = rel_err(lg1[:, 0], full)
    log(f"slice: decode-vs-prefill rel. err {rel:.3g} (limit {REL_TOL_FULL})")
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
    stats = {"arch": ARCH, "batch": BATCH, "prompt_len": PROMPT,
             "decode_tokens": DECODE, "requests": len(done),
             "p50_ms": float(np.percentile(lats, 50)),
             "p99_ms": float(np.percentile(lats, 99)),
             "tokens_per_s": len(done) * DECODE / wall,
             "prefill_ms": (t1 - t0) * 1e3, "decode_step_ms": (t2 - t1) * 1e3,
             "decode_vs_prefill_rel_err": rel,
             "alone": profile_alone(model, params, cfg, toks, tok, buf),
             "profile": profile_pump(eng, prompts[:BATCH], wall * 1e3 / PUMPS)}
    del eng, model, params, cache
    torch.cuda.empty_cache()
    return launches, stats


def kernel_groups(prof):
    """Device ms by kernel group in one torch.profiler run."""
    groups = {"flash_attention": 0.0, "decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for key, us in device_kernels_us(prof):
        name = key.lower()
        if "flash_attn_kernel" in name:
            groups["flash_attention"] += us / 1e3
        elif "decode_attn" in name:
            groups["decode_attention"] += us / 1e3
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
    """Operations of the prefill's matrix products, from the shapes: QKV, O
    and the three SwiGLU projections in every layer, and the head on the
    last token."""
    T, d, hd = batch * seq, cfg.d_model, cfg.hd
    per_layer = (2 * T * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + 2 * T * cfg.n_heads * hd * d + 3 * 2 * T * d * cfg.d_ff)
    return cfg.n_layers * per_layer + 2 * batch * d * cfg.vocab_size


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
    timed pumps) in which no kernel ran."""
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=1000 + i, tokens=p, arrival_s=time.time()))
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        eng.pump()
    groups = kernel_groups(prof)
    return {"pump_ms": pump_ms, "device_ms": groups,
            "idle_share": max(0.0, 1.0 - sum(groups.values()) / pump_ms)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check_small_against_cpu(dev):
    """A reduced qwen3-4b on the card against the same weights on the CPU
    (plain path): logits of prefill and three decode steps."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    cfg = reduced(get_config(ARCH))
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, dev)
    params_cpu = cpu_model.init(seed=1)
    params_gpu = {k: ([{kk: _to(vv, dev) for kk, vv in b.items()} for b in v]
                      if k == "blocks" else _to(v, dev)) for k, v in params_cpu.items()}
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    worst = 0.0
    with torch.inference_mode():
        cc = cpu_model.init_cache(2, 32, dtype=torch.float32)
        gc = gpu_model.init_cache(2, 32, dtype=torch.float32)
        lc, cc = cpu_model.prefill(params_cpu, {"tokens": tokens}, cc)
        lg, gc = gpu_model.prefill(params_gpu, {"tokens": tokens.to(dev)}, gc)
        worst = max(worst, rel_err(lg.cpu(), lc))
        for _ in range(3):
            tok = lc.reshape(2, -1).argmax(-1).to(torch.int32)[:, None]
            lc, cc = cpu_model.decode_step(params_cpu, tok, cc)
            lg, gc = gpu_model.decode_step(params_gpu, tok.to(dev), gc)
            worst = max(worst, rel_err(lg.cpu(), lc))
    log(f"small: reduced {ARCH} on the card vs CPU, worst rel. err {worst:.3g} "
        f"(limit {REL_TOL_SMALL})")
    assert worst <= REL_TOL_SMALL, worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Phase 5: timing at the slice's shapes
# ---------------------------------------------------------------------------

def time_flash(dev, rng, launches, err):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, H, KV, hd = BATCH, PROMPT, 32, 8, 128
    q = rand(rng, (B, S, H, hd), torch.float32, dev)
    k, v = rand(rng, (B, S, KV, hd), torch.float32, dev), rand(rng, (B, S, KV, hd), torch.float32, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    with torch.inference_mode():
        ms = device_ms(lambda i: flash_attention(q, k, v), 1)
        plain_ms = device_ms(lambda i: ref.attention_ref(q, k, v), 1, iters=5)
        lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 1)
    pairs = S * (S + 1) // 2                      # causal (q, k) pairs per head
    flops = 4 * hd * pairs * B * H                # QK^T and PV, 2 flops per FMA
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    bound_ms, by = bound(flops, nbytes)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": launches["flash_attention"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms}


def time_decode(dev, rng, launches, err):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    n_copies = 8                                  # 8 x 17 MB of cache > 50 MB L2
    q, caches, qpos, kvpos = decode_inputs(dev, rng, n_copies)
    views = [(kc.transpose(1, 2), vc.transpose(1, 2)) for kc, vc in caches]
    B, H, hd = q.shape[0], q.shape[2], q.shape[3]
    KV, S_buf = caches[0][0].shape[1], caches[0][0].shape[2]
    mask = (kvpos >= 0) & (kvpos <= qpos[:, None])
    qh = q.transpose(1, 2)                        # (B, H, 1, hd)
    with torch.inference_mode():
        ms = device_ms(lambda i: decode_attention(q, *views[i], qpos, kvpos), n_copies, 40)
        plain_ms = device_ms(lambda i: ref.decode_attention_ref(q, *views[i], qpos, kvpos),
                           n_copies, 16)
        lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
            qh, caches[i][0], caches[i][1], attn_mask=mask[:, None, None, :],
            enable_gqa=True), n_copies, 40)
    valid = int(mask.sum())                       # valid (b, slot) pairs
    flops = 4 * hd * H * valid
    nbytes = 4 * (2 * B * KV * S_buf * hd + B * S_buf + B + 2 * B * H * hd)
    bound_ms, by = bound(flops, nbytes)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:64",
            "launches": launches["decode_attention"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms}


def main():
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
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    _build.load()
    log(f"build: {_build.build_seconds:.1f} s -> {_build.library_path().name}")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(0)
    flash_err = check_flash(dev, rng)
    decode_err = check_decode(dev, rng)
    check_small_against_cpu(dev)
    launches, stats = run_slice(dev)
    kernels = [time_flash(dev, rng, launches, flash_err),
               time_decode(dev, rng, launches, decode_err)]
    for k in kernels:
        log(f"timing: {k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']}); "
            f"plain / kernel = {k['plain_ms'] / k['ms']:.2f}, "
            f"{k['bound_ms'] / k['ms']:.1%} of bound")
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"slice": {**stats, "gpu": smi}}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
