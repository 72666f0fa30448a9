"""The serving pass's profiler spans (``repro_torch.profiling.spans.span``)
on the CPU: no profiler call while none records, and while one does the
engine's phases and the model's ``model.embed`` / ``model.mix`` /
``model.ffn`` / ``model.head`` on the per-pass log's clock."""
import pytest
import torch
from repro_torch.profiling import spans

from tests._torch_spans import B, engine, kineto, mine, submit


def test_no_profiler_call_while_none_records(monkeypatch):
    eng = engine()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    submit(eng, 3)
    while eng.queue:
        assert eng.pump()
    assert len(mine(eng)) == 2


# (model.mix, model.ffn) spans in one forward of the cut configurations:
# one of each a block; zamba2's shared attention block (one group of two
# Mamba2 layers) adds a mixer and its MLP, its Mamba2 blocks have no FFN
SPANS_PER_FORWARD = {"qwen3-4b": (2, 2), "rwkv6-1.6b": (2, 2), "zamba2-2.7b": (3, 1)}


@pytest.mark.parametrize("arch", sorted(SPANS_PER_FORWARD))
def test_profiler_spans_on_the_records_clock(arch):
    eng = engine(arch)                   # decode_tokens 2: a prefill and a decode step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        submit(eng, 2 * B)
        while eng.queue:
            eng.pump()
    assert not torch.autograd.profiler._is_profiler_enabled
    events = kineto(prof)
    names = [n for n, _ in events]
    forwards = 2 * 2
    mix, ffn = SPANS_PER_FORWARD[arch]
    assert names.count("model.mix") == forwards * mix
    assert names.count("model.ffn") == forwards * ffn
    assert names.count("model.embed") == names.count("model.head") == forwards
    assert all(names.count(p) == 2 for p in spans.PHASES)
    # the second pass's dispatch span starts where its record says dispatch began
    rec = mine(eng)[-1]
    start = max(s for n, s in events if n == "engine.dispatch")
    assert abs(start - rec.stamps_ns[1]) < 1_000_000
