"""Serving launcher for the port: the batched engine on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu

Serves a reduced model (2 layers, d_model 256) as the JAX launcher's
``--mode engine`` does, of any family the port runs: dense attention
(qwen3-4b and the other "attn" configs without MoE, encoder or M-RoPE),
RWKV6 (rwkv6-1.6b) and Mamba2 with shared attention (zamba2-2.7b).  On the
card the prompt goes through the CUDA kernels (flash attention, or the
rwkv6 / SSD scan) and each decode step through flash-decode attention
where the model has attention; ``--device cpu`` runs their plain
versions.  Cluster mode (provision + simulate) waits for the simulator
slice of the port; the planner it provisions with is
``repro_torch.core.provisioner``.
"""
import argparse
import time


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
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default cuda:0 (fails without CUDA); 'cpu' on request")
    args = ap.parse_args()
    engine(args.arch, args.requests, args.device)


if __name__ == "__main__":
    main()
