"""engine_ms.w6: the engine's own work in a pass, the queue's take and the
padding, then the completions (``engine.take`` + ``engine.complete``),
its mean over the pumps ``pass_ms.w6`` reads, in ms (program span;
engine: batching and padding)."""
from harness.passlog import phase_ms


def read(run):
    return phase_ms(run, "engine.take", "engine.complete")
