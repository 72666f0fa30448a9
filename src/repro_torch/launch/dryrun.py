"""Multi-pod dry run: run EVERY (architecture x input shape) step once on
the abstract production meshes, on fake tensors, proving the distribution
config is coherent without the hardware.

Counterpart of the JAX package's ``launch/dryrun.py``.  There is no
compiler to ask: ``run_one`` builds the step on the fake mesh
(``launch.mesh.make_production_mesh``, CUDA devices over a fake process
group), makes its arguments as DTensors over rank 0's shards on the meta
device, and runs the step once with ``profiling.step_analysis`` counting.
DTensor plans the collectives for CUDA, each op computes only its output's
shape, and the kernels' custom ops answer with their fake
implementations: nothing is allocated on any device, and no card is
needed.  (Meta shards, not ``FakeTensorMode``: DTensor's own bookkeeping
makes plain tensors and reads them back, which an ambient fake mode
would fake too.)  Each record holds:

  * arg_bytes_per_dev  -- the sum of rank 0's shards of params, optimizer
                          state and inputs (exact, from the placements)
  * temp_bytes_per_dev -- the peak of the bytes of rank 0's tensors made
                          during the step and alive at once (the eager
                          step's new params and moments included)
  * fits_hbm           -- their sum under the H100's 80 GB
  * the roofline terms per device on H100 constants (compute / memory /
    collective seconds, dominant term, collective breakdown)
  * model_flops_global and useful_flops_ratio
  * mesh, mesh_device, torch -- where it was counted: the mesh's shape,
                          its device type and the torch version

``--save-hlo-dir DIR`` (the JAX CLI's flag) writes, beside each record,
``DIR/{arch}_{shape}_{mesh}.ops``: there is no HLO, so the file holds the
program the record was counted from, one JSON line per op that
``StepAnalysis`` counted on rank 0 (the op, its inputs' and outputs'
dtypes and shapes, its flops and bytes, and for a collective its kind,
group size and ring bytes).  Its flops and ring bytes sum to the record's
``flops_per_dev`` and ``collective_bytes_per_dev``.

A fake process group of 512 ranks cannot share a process with a real one,
so the dry run runs in a process of its own (the CLI, a subprocess).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # full matrix
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod      # 512-device mesh
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --layers 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k --save-hlo-dir ops/

``--layers N`` cuts every config to N decoder layers (the record's
``layers``), a depth cut for a quick run; the widths stay.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ASSIGNED
from repro_torch.launch.shapes import SHAPES, applicable, effective_config, skip_reason
from repro_torch.launch.steps import build_step
from repro_torch.models import moe
from repro_torch.profiling import step_analysis as SA

HBM_PER_DEVICE = SA.HBM_BYTES     # H100 SXM, 80 GB


def model_flops(arch: str, shape_name: str, *, cfg=None, shape=None) -> float:
    """MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N_active*D for inference
    (of ``cfg`` and ``shape`` where a cut step gives its own)."""
    cfg = cfg or effective_config(arch, shape_name)
    shape = shape or SHAPES[shape_name]
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _where(mesh) -> dict:
    """What a record was counted on: the mesh's shape, its device type
    (DTensor plans collectives by it: a CPU mesh swaps an all-to-all for an
    all-gather) and the torch version."""
    import torch
    return {"mesh": mesh_name(mesh), "mesh_device": mesh.device_type,
            "torch": torch.__version__}


def run_one(arch: str, shape_name: str, mesh, save_ops=None, **step_kw):
    """Build the step on ``mesh`` and run it once on meta shards under
    ``StepAnalysis``; the record of the reference's fields.  ``save_ops``:
    a path for the counted ops, one JSON line each."""
    t0 = time.time()
    # the MoE layers' drop counters add up over calls: a step on another
    # layout could not add its counts to an earlier step's
    moe.reset_drop_counts()
    st = build_step(arch, shape_name, mesh, **step_kw)
    args = st.abstract_dtensors()
    with SA.StepAnalysis(device="meta", record=save_ops is not None) as a:
        out = st.fn(*args)
    del out, args
    if save_ops is not None:
        with open(save_ops, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in a.records)
    elapsed = time.time() - t0
    r = SA.roofline(a)
    n_dev = mesh.size()
    mf = model_flops(arch, shape_name, cfg=st.cfg, shape=step_kw.get("shape"))
    flops_global = r.flops * n_dev
    arg = st.arg_bytes_per_dev()
    return {
        "arch": arch,
        "shape": shape_name,
        **_where(mesh),
        "layers": st.cfg.n_layers,
        "status": "ok",
        "run_s": elapsed,
        "ops_per_dev": a.ops,
        "temp_bytes_per_dev": int(a.peak_bytes),
        "arg_bytes_per_dev": int(arg),
        "fits_hbm": bool(a.peak_bytes + arg < HBM_PER_DEVICE),
        "flops_per_dev": r.flops,
        "hbm_bytes_per_dev": r.hbm_bytes,
        "collective_bytes_per_dev": r.collective_bytes,
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "dominant": r.dominant,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "per_collective": dict(r.per_collective),
    }


def _line(rec) -> str:
    mem = (rec["temp_bytes_per_dev"] + rec["arg_bytes_per_dev"]) / 2 ** 30
    return (f"[ok]   {rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"{rec['mesh_device']:4s} torch={rec['torch']} "
            f"run={rec['run_s']:6.1f}s mem={mem:7.2f}GiB fits={rec['fits_hbm']} "
            f"dom={rec['dominant']:10s} c/m/i(ms)={1e3 * rec['compute_s']:9.2f}/"
            f"{1e3 * rec['memory_s']:9.2f}/{1e3 * rec['collective_s']:9.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every config to this many decoder layers")
    ap.add_argument("--save-hlo-dir", default=None,
                    help="write each step's counted ops to DIR/{arch}_{shape}_{mesh}.ops")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_production_mesh
    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    meshes = [make_production_mesh(multi_pod=m) for m in pods]

    records = []
    for mesh in meshes:
        name, where = mesh_name(mesh), _where(mesh)
        for arch in archs:
            for shape_name in shapes:
                if not applicable(arch, shape_name):
                    records.append({"arch": arch, "shape": shape_name, **where,
                                    "status": "skip", "reason": skip_reason(arch, shape_name)})
                    print(f"[skip] {arch} {shape_name}: {skip_reason(arch, shape_name)}",
                          flush=True)
                    continue
                t0 = time.time()
                kw = {}
                if args.layers:
                    kw["cfg"] = effective_config(arch, shape_name).replace(n_layers=args.layers)
                if args.save_hlo_dir:
                    os.makedirs(args.save_hlo_dir, exist_ok=True)
                    kw["save_ops"] = os.path.join(args.save_hlo_dir,
                                                  f"{arch}_{shape_name}_{name}.ops")
                try:
                    rec = run_one(arch, shape_name, mesh, **kw)
                    records.append(rec)
                    print(_line(rec), flush=True)
                except Exception as e:  # noqa: BLE001 - record and continue
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shape_name, **where,
                                    "status": "fail", "run_s": time.time() - t0,
                                    "error": f"{type(e).__name__}: {e}"[:2000]})
                    print(f"[FAIL] {arch} {shape_name} {name} {mesh.device_type}: "
                          f"{type(e).__name__}: {e}"[:400],
                          flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"] == "skip")
    n_fail = sum(1 for r in records if r["status"] == "fail")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skip, {n_fail} fail ==")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
