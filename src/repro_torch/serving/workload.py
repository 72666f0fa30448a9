"""Serving workload sets: the 12-workload App study (paper Table 3
analogue) over four heterogeneous served models from the assigned
architecture pool.

Paper Table 3 uses 4 CNNs x 3 Apps with latency SLOs (ms) and expected
throughputs (req/s).  Our analogue serves 4 transformer-family models
(attention-free RWKV6, dense GQA, VLM, encoder-decoder audio) at request
shapes sized for sub-100 ms single-chip inference on TPU v5e.

A copy of the JAX package's ``repro.serving.workload``; the synthetic
draws keep numpy's ``default_rng``, so both packages make the same specs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.types import WorkloadSpec
from repro_torch.profiling.metrics import ServedModelDesc, serving_models

# (model, latency SLO ms, rate req/s) per App — W1..W12.
APP_TABLE = [
    # App1: tight latency
    ("rwkv6-1.6b",        60.0, 120.0),   # W1
    ("qwen1.5-4b",        90.0,  60.0),   # W2
    ("qwen2-vl-7b",      130.0,  60.0),   # W3
    ("whisper-large-v3", 130.0,  30.0),   # W4
    # App2: high rate
    ("rwkv6-1.6b",        90.0, 250.0),   # W5
    ("qwen1.5-4b",       180.0,  60.0),   # W6
    ("qwen2-vl-7b",      180.0,  60.0),   # W7
    ("whisper-large-v3",  90.0,  60.0),   # W8
    # App3: relaxed latency
    ("rwkv6-1.6b",       130.0, 120.0),   # W9
    ("qwen1.5-4b",       240.0,  30.0),   # W10
    ("qwen2-vl-7b",      240.0,  60.0),   # W11
    ("whisper-large-v3", 240.0,  60.0),   # W12
]


def twelve_workloads() -> List[WorkloadSpec]:
    return [WorkloadSpec(name=f"W{i+1}", model=m, slo_ms=slo, rate_rps=rate)
            for i, (m, slo, rate) in enumerate(APP_TABLE)]


def specs_by_name() -> Dict[str, WorkloadSpec]:
    return {w.name: w for w in twelve_workloads()}


def models() -> Dict[str, ServedModelDesc]:
    return serving_models()


def synthetic_workloads(m: int, seed: int = 0) -> List[WorkloadSpec]:
    """m synthetic workloads for the large-cluster scale sweep (paper
    Sec. 5.4 claims Alg. 1 provisions m=1000 in 4.61 s).

    Each workload is a jittered sample of an `APP_TABLE` row — SLO x
    U[0.8, 1.6), rate x U[0.5, 1.5) — so the mix stays feasible on the
    fitted profiles while exercising heterogeneous SLO/rate pressure.
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(m):
        model, slo, rate = APP_TABLE[int(rng.integers(len(APP_TABLE)))]
        out.append(WorkloadSpec(
            name=f"S{i}", model=model,
            slo_ms=round(float(slo * rng.uniform(0.8, 1.6)), 1),
            rate_rps=round(float(rate * rng.uniform(0.5, 1.5)), 1)))
    return out


# The illustrative 3-workload example of paper Sec. 2.3 (Table 1).
def three_workloads() -> List[WorkloadSpec]:
    return [
        WorkloadSpec(name="A", model="rwkv6-1.6b", slo_ms=60.0, rate_rps=120.0),
        WorkloadSpec(name="R", model="qwen1.5-4b", slo_ms=150.0, rate_rps=60.0),
        WorkloadSpec(name="V", model="qwen2-vl-7b", slo_ms=200.0, rate_rps=60.0),
    ]
