"""pass_ms.w6: the window's pumps' summed wall time over their number
(host clock; model step)."""
from harness.readers import pass_ms


def read(run):
    return pass_ms(run)
