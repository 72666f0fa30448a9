"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Runs one cell of ``BENCHMARK.json`` on the
card: set-up (the kernels' library, built into the checkout's
``build/kernels/`` on a first run, the weights drawn on the card from the
seed, the engine and its warm-up), the measured window, then the check
that decides ``correct``.  Prints the check's numbers beside their limits
as the last lines of standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; ``checks`` last.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, without the port beside it, and where JAX, flax or the
JAX package is loaded once the window has closed.
"""
import time

T_START = time.time()          # before torch loads: set-up counts from here

import argparse                # noqa: E402
import subprocess              # noqa: E402
import sys                     # noqa: E402
from pathlib import Path       # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str):
    print(f"[perfbench {time.time() - T_START:7.2f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``repro_torch`` is another name)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"no port at {ROOT / 'src' / 'repro_torch'}: run from a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    from harness import report
    from harness.bench import run_cell
    from harness.cell import load_cell
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"{args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log)

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return 3
    try:
        out = report.line(res, torch.cuda.get_device_name(0), cell.chips, bool(args.trace),
                          power_limit())
    except report.NoDeviceTime as e:
        log(str(e))
        return 4
    log(f"card: {out['card']}; peak memory {res['memory_peak_bytes']} bytes; "
        f"{res['pumps']} pumps; launches {res['launches']}")
    if args.trace:
        log(f"traced: busy {out['device']['busy_s']} s of {out['device']['window_s']} s")
    report.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
