"""What the serving pass's timing leaves as it was, on the CPU: the tokens
with a profiler on and off, the model layer's imports (no serving module),
and the engine's latencies, now bounded."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import repro_torch
from repro_torch.serving import engine as engine_mod

from tests._torch_spans import B, engine, submit


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-1.6b"])
def test_the_same_tokens_with_the_profiler_on_and_off(arch):
    eng = engine(arch, decode_tokens=3)
    submit(eng, B)
    off = [c.tokens for c in eng.pump()]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        submit(eng, B)
        on = [c.tokens for c in eng.pump()]
    assert len(off) == len(on) == B
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_the_model_layer_loads_no_serving_module():
    """``models/transformer.py`` takes ``span`` from ``profiling.spans``,
    which imports only torch: the model does not load the serving layer."""
    code = ("import sys, repro_torch.models.zoo; "
            "print([m for m in sys.modules if m.startswith('repro_torch.serving')])")
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src}, check=True)
    assert out.stdout.strip() == "[]"


def test_latencies_are_bounded_and_p99_reads_the_newest(monkeypatch):
    assert engine_mod.LATENCY_WINDOW >= 200               # p99_ms's default window
    monkeypatch.setattr(engine_mod, "LATENCY_WINDOW", 4)
    eng = engine(decode_tokens=1)
    submit(eng, 6, t0=time.time())
    while eng.queue:
        eng.pump()
    assert len(eng.latencies) == 4
    assert eng.p99_ms(window=2) == pytest.approx(np.percentile(list(eng.latencies)[-2:], 99))
