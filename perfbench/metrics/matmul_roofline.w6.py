"""matmul_roofline.w6: cuBLAS products' least time for the traced
passes' rows over their device time, in % (device trace)."""
from harness.readers import roofline


def read(run):
    return roofline(run, "matmul")
