"""Serving launcher for the port: provision with iGniter, then serve.

Cluster-scale (simulator, the paper's 12-workload study):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode cluster [--strategy iGniter]

Single-host engine (reduced model, real batched inference on one GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --arch zamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --arch mixtral-8x22b

Both modes run on ``--device`` (default cuda:0, failing without CUDA;
``cpu`` on request), as the JAX launcher's two modes run on its backend.
Cluster mode fits the tpu-v5e profiles on the port's simulated testbed,
provisions the five strategies (`core.experiments.all_plans`, the Alg. 2
grant loop as a CUDA kernel on a card) and simulates the chosen plan
(`serving.simulator.simulate_plan`, the latency tables as a CUDA kernel),
printing each workload's p99 and rate against its SLO.  Engine mode serves
a reduced model (2 layers, d_model 256) of any family the port runs:
decoder-only attention with a dense MLP (qwen3-4b, yi-6b, qwen1.5-4b,
minitron-4b's GELU MLP) or top-k routed experts (mixtral-8x22b,
dbrx-132b), RWKV6 (rwkv6-1.6b) and Mamba2 with shared attention
(zamba2-2.7b); not yet the encoder and vision models (whisper-large-v3,
qwen2-vl-7b).  On the card the prompt goes through the CUDA kernels (flash
attention, or the rwkv6 / SSD scan) and each decode step through
flash-decode attention where the model has attention; ``--device cpu``
runs their plain versions.
"""
import argparse
import time


def cluster(strategy: str, duration: float, poisson: bool, device=None):
    from repro_torch.core.experiments import all_plans, fitted_context
    from repro_torch.serving.workload import specs_by_name
    ctx = fitted_context()
    plans = all_plans(ctx, device=device)
    if strategy not in plans:
        raise SystemExit(f"unknown strategy {strategy}; one of {list(plans)}")
    from repro_torch.serving.simulator import simulate_plan
    from repro_torch.serving.workload import models
    res = simulate_plan(plans[strategy], models(), ctx.hw,
                        duration_s=duration, shadow=(strategy == "iGniter"),
                        poisson=poisson, device=device)
    sb = specs_by_name()
    print(plans[strategy].summary())
    print(f"devices={plans[strategy].n_gpus} "
          f"cost=${plans[strategy].cost_per_hour():.2f}/h "
          f"arrivals={'poisson' if poisson else 'constant'}")
    for w, m in sorted(res.per_workload.items(), key=lambda kv: int(kv[0][1:])):
        s = sb[w]
        flag = "VIOLATION" if (m["p99_ms"] > s.slo_ms
                               or m["rps"] < 0.95 * s.rate_rps) else "ok"
        print(f"  {w:4s} p99={m['p99_ms']:7.1f}/{s.slo_ms:5.0f} ms "
              f"rps={m['rps']:6.1f}/{s.rate_rps:5.0f} {flag}")


def engine(arch: str, n_requests: int, device=None):
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(REGISTRY[arch], layers=2, d_model=256)
    eng = ServingEngine(cfg, batch_size=4, prompt_len=32, device=device)
    rng = np.random.default_rng(0)
    done = []
    for i in range(n_requests):
        eng.submit(Request(rid=i, tokens=rng.integers(
            3, cfg.vocab_size, size=32).astype(np.int32),
            arrival_s=time.time()))
        if (i + 1) % 4 == 0:
            done.extend(eng.pump())
    done.extend(eng.pump())
    lats = np.array([c.latency_ms for c in done])
    print(f"{arch} on {eng.device}: served {len(done)} requests, "
          f"p50={np.percentile(lats, 50):.1f} ms "
          f"p99={np.percentile(lats, 99):.1f} ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("cluster", "engine"), default="cluster")
    ap.add_argument("--strategy", default="iGniter")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--poisson", action="store_true")
    ap.add_argument("--arch", default="qwen3-4b",
                    help="engine mode: qwen3-4b, qwen3-4b-swa, yi-6b, qwen1.5-4b, "
                         "minitron-4b, mixtral-8x22b, dbrx-132b, rwkv6-1.6b or zamba2-2.7b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default cuda:0 (fails without CUDA); 'cpu' on request")
    args = ap.parse_args()
    if args.mode == "cluster":
        cluster(args.strategy, args.duration, args.poisson, args.device)
    else:
        engine(args.arch, args.requests, args.device)


if __name__ == "__main__":
    main()
