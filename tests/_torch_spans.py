"""Shared set-up of the serving pass's timing tests
(``tests/test_torch_spans*.py``): a CPU engine on a cut configuration, its
requests, its records in the per-pass log, and a profiler's kineto events.
Each of those files holds at most four tests, as ``tests/_torch_parity.py``
explains."""
import numpy as np

from repro_torch.configs import REGISTRY, reduced
from repro_torch.profiling import spans
from repro_torch.serving.engine import Request, ServingEngine

B, S = 2, 8


def engine(arch="qwen3-4b", decode_tokens=2):
    return ServingEngine(reduced(REGISTRY[arch]), batch_size=B, prompt_len=S,
                         decode_tokens=decode_tokens, seed=0, device="cpu")


def submit(eng, n, t0=1000.0):
    rng = np.random.default_rng(n)
    for i in range(n):
        eng.submit(Request(rid=i, tokens=rng.integers(3, eng.cfg.vocab_size, size=S)
                           .astype(np.int32), arrival_s=t0 + i))


def mine(eng):
    """The engine's records in the process's per-pass log."""
    return [r for r in spans.passes() if r.engine == eng.engine_id]


def kineto(prof):
    """(name, start ns) of each event a profiler recorded."""
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]
