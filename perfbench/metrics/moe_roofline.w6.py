"""moe_roofline.w6: the grouped expert kernel's least time for the traced
passes' real rows over its device time, in % (device trace).

Its time is the traced window's device time of every kernel named
``moe_gemm_kernel`` (the gate-and-up and the down instantiations), read
from the breakdown's ``device_ops``; the trace's groups count it with the
products (``matmul``), since its name holds ``gemm``.  Its operations and
bytes are ``flops/<family>.py``'s ``moe`` entry.  None where the trace
names no such kernel (a program without it, or a family without ``moe``)."""
KERNEL = "moe_gemm_kernel"


def read(run):
    t = run.trace
    if not t or not t["pumps"]:
        return None
    seconds = sum(s for name, s in t["breakdown"]["device_ops"] if KERNEL in name)
    if seconds <= 0:
        return None
    flops = nbytes = 0.0
    for p in t["pumps"]:
        counts = run.flops.pass_counts(run.sz, p["rows"], run.seq)
        if "moe" not in counts:
            return None
        f, b = counts["moe"]
        flops, nbytes = flops + f, nbytes + b
    least = max(flops / run.peaks["flops_per_s"], nbytes / run.peaks["bytes_per_s"])
    return 100.0 * least / seconds
