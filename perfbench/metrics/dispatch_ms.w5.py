"""dispatch_ms.w5: the host's time to enqueue a pass, every launch from the
copy to the device to the last op (``engine.dispatch``), its mean over
the pumps ``pass_ms.w5`` reads, in ms (program span; model step)."""
from harness.passlog import phase_ms


def read(run):
    return phase_ms(run, "engine.dispatch")
