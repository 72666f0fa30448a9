"""ssd_scan_roofline.w6: ssd_scan_kernel's least time for the traced
passes' real rows over its device time, in % (device trace)."""
from harness.readers import roofline


def read(run):
    return roofline(run, "ssd_scan")
