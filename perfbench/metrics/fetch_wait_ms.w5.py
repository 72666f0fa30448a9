"""fetch_wait_ms.w5: the host blocked on the pass's tokens after its last
launch, the device's work left over and the copy back (``engine.fetch``),
its mean over the pumps ``pass_ms.w5`` reads, in ms (program span; device)."""
from harness.passlog import phase_ms


def read(run):
    return phase_ms(run, "engine.fetch")
