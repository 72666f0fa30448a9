"""Readings for the limits of ``correct``: the program's numbers over many
seeds and the control's, one process on the card.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 4 --out build/calibrate.json

Each seed is a whole run of the cell (``run_cell``: its own weights, a
window of ``--seconds`` at the cell's own load, the check); for a control
seed the reference in TF32 then stands in the program's place on the same
sampled prompts (``check.control_numbers``).  Prints one JSON line a seed
and writes them all to ``--out``.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check  # noqa: E402
from harness.bench import program_config, run_cell  # noqa: E402
from harness.cell import load_cell  # noqa: E402
from harness.traffic import make_schedule  # noqa: E402
from harness.weights import make_weights  # noqa: E402


def control(cell, seed, sample, device):
    from repro_torch.models.zoo import build_model
    cfg, sz = program_config(cell)
    params = make_weights(build_model(cfg, "cpu").abstract_params(torch.float32),
                          cell.config["init"], seed, device)
    sched = make_schedule(cell.traffic, seed, cfg.vocab_size)
    prompts = np.stack([sched.prompt(r) for r in sample])
    ref = check.reference_module(cell.config["family"])
    out = check.control_numbers(ref, params, sz, prompts, device)
    del params
    return out


PLAIN = {"dense": ("repro_torch.models.attention", "flash_attention", "attention_ref"),
         "rwkv6": ("repro_torch.kernels.ops", "rwkv6_scan", "rwkv6_ref")}


def witness(cell, seed, sample, device):
    """The program's model outside the engine, at the engine's batch, with
    its kernel and with the kernel's plain version (``kernels/ref.py``) in
    its place: each one's ``logit_err`` against the reference, to tell the
    kernel's rounding from the rest."""
    import importlib
    from repro_torch.kernels import ref as plain
    from repro_torch.models.zoo import build_model
    cfg, sz = program_config(cell)
    model = build_model(cfg, device)
    params = make_weights(model.abstract_params(torch.float32), cell.config["init"], seed,
                          device)
    sched = make_schedule(cell.traffic, seed, cfg.vocab_size)
    prompts = np.stack([sched.prompt(r) for r in sample])
    B = int(cell.traffic["batch_size"])
    ref = check.reference_module(cell.config["family"])
    want = check.reference_logits(ref, params, sz, prompts, device)
    mod_name, attr, plain_name = PLAIN[cell.config["family"]]
    mod = importlib.import_module(mod_name)
    kernel = getattr(mod, attr)
    out = {}
    for label in ("kernel", "plain"):
        if label == "plain":
            fn = getattr(plain, plain_name)
            setattr(mod, attr, (lambda q, k, v, causal=True, window=None: fn(q, k, v, causal=causal,
                                                                             window=window))
                    if attr == "flash_attention" else
                    (lambda r, k, v, logw, u, s0=None: fn(r, k, v, logw, u, s0)))
        got = []
        with torch.inference_mode():
            for lo in range(0, len(prompts), B):
                toks = torch.from_numpy(prompts[lo:lo + B]).to(device)
                cache = model.init_cache(len(toks), toks.shape[1] + 8, dtype=torch.float32)
                got.append(model.prefill(params, {"tokens": toks}, cache)[0])
        setattr(mod, attr, kernel)
        out[label] = float(check.logit_errs(torch.cat(got), want).max())
    del params
    return out


def calibrate(cell, seeds, control_seeds, seconds, device, log=print, witness_seeds=()):
    rows = []
    for seed in seeds:
        t = time.time()
        res = run_cell(cell, seed, seconds, False, device, time.time())
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: c["value"] for k, c in res["checks"].items()},
               "requests": len(res["sample"]), "pumps": res["pumps"]}
        if seed in control_seeds:
            row["control"] = control(cell, seed, res["sample"], device)
        if seed in witness_seeds:
            row["witness"] = witness(cell, seed, res["sample"], device)
        row["s"] = time.time() - t
        rows.append(row)
        log(json.dumps(row))
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    wit = {int(s) for s in a.witness_seeds.split(",") if s}
    rows = calibrate(load_cell(a.workload), seeds, ctrl, a.seconds, "cuda",
                     lambda m: print(m, flush=True), wit)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"workload": a.workload, "card": torch.cuda.get_device_name(0),
                                       "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
