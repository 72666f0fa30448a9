"""Serving slices of two checkouts of the port on one card, side by side.

Each run is a fresh process started in a checkout's root; it builds (or
loads) that checkout's kernels and serves each model through that
checkout's own ``chip_smoke.run_slice`` (phase 4 of ``chip_smoke.py``:
``BATCH`` x ``PUMPS`` requests through ``ServingEngine`` at full width,
the depth given here), and reports per model the request latency's p50
and p99, tokens/s, one prefill's and one decode step's ms, the timed
pumps' mean wall ms and the card's idle share over a profiled pump.

    python3 serve_ab.py --tree OLD --tree . --order 0110 \\
        --model qwen3-4b:8 --model rwkv6-1.6b --model zamba2-2.7b:18

``--order`` names the trees by index, run after run (``0110``: old, new,
new, old, so a drift of the host shows as a difference between the two
runs of one tree).  OLD is a second checkout, e.g. ``git archive`` of the
parent unpacked into a directory that ``.gitignore`` lists.  One JSON
line per run, then a last line with each tree's medians.  Needs a GPU.

``--decode-kernel`` also times, in each run, the served decode kernel at
qwen3-4b's first decode step's cache (4, 8, 524, 128) through the
checkout's own ``chip_smoke.time_decode`` (device ms a call, phase 5);
with it ``--model`` may be left out:

    python3 serve_ab.py --tree OLD --tree . --order 0110 --decode-kernel
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

KEYS = ("p50_ms", "p99_ms", "tokens_per_s", "prefill_ms", "decode_step_ms",
        "pump_ms", "idle_share")

CHILD = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
_build.load()
dev = resolve_device()
rows = []
for arch, layers, encoder_layers in json.loads(sys.argv[1]):
    t = time.perf_counter()
    _, st = c.run_slice(dev, arch, layers, encoder_layers)
    rows.append({"arch": arch, "layers": st["layers"], "launches": st["launches"],
                 "slice_s": time.perf_counter() - t,
                 **{k: st[k] for k in ("p50_ms", "p99_ms", "tokens_per_s", "prefill_ms",
                                       "decode_step_ms")},
                 "pump_ms": st["profile"]["pump_ms"],
                 "idle_share": st["profile"]["idle_share"]})
out = {"slices": rows}
if sys.argv[2] == "1":
    with torch.inference_mode():
        out["decode_kernel_ms"] = c.time_decode(dev, np.random.default_rng(0))["ms"]
print("SLICES " + json.dumps(out), flush=True)
"""


def parse_model(text):
    """``arch[:layers[:encoder_layers]]`` -> (arch, layers or None, encoder layers or None)."""
    arch, *depth = text.split(":")
    depth = [int(d) for d in depth] + [None, None]
    return arch, depth[0], depth[1]


def run(tree: Path, models, timeout: int, decode_kernel: bool = False):
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(models),
                           "1" if decode_kernel else "0"], cwd=tree,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": ""})
    sys.stderr.write(proc.stderr[-4000:])
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("SLICES ")), None)
    if proc.returncode != 0 or line is None:
        raise SystemExit(f"serve_ab: {tree} exited {proc.returncode}:\n{proc.stdout[-4000:]}")
    return json.loads(line[len("SLICES "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True, type=Path)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--model", action="append", default=[], type=parse_model)
    ap.add_argument("--decode-kernel", action="store_true",
                    help="also time the served decode kernel at qwen3-4b's cache")
    ap.add_argument("--timeout", type=int, default=600, help="seconds a run may take")
    args = ap.parse_args(argv)
    if not args.model and not args.decode_kernel:
        ap.error("give --model, --decode-kernel or both")
    runs = {}
    for i in args.order:
        tree = args.tree[int(i)].resolve()
        out = run(tree, args.model, args.timeout, args.decode_kernel)
        print(json.dumps({"tree": str(tree), "run": len(runs.get(i, [])), **out}), flush=True)
        runs.setdefault(i, []).append(out)
    medians = {}
    for i, rs in sorted(runs.items()):
        med = {row["arch"]: {k: float(np.median([r["slices"][j][k] for r in rs])) for k in KEYS}
               for j, row in enumerate(rs[0]["slices"])}
        if args.decode_kernel:
            med["decode_kernel_ms"] = float(np.median([r["decode_kernel_ms"] for r in rs]))
        medians[str(args.tree[int(i)])] = med
    print(json.dumps({"medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
