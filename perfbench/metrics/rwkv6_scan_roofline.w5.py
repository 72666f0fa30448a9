"""rwkv6_scan_roofline.w5: rwkv6_scan_kernel's least time for the traced
passes' rows over its device time, in % (device trace)."""
from harness.readers import roofline


def read(run):
    return roofline(run, "rwkv6_scan")
