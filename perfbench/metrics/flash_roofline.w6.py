"""flash_roofline.w6: flash_attn_kernel's least time for the traced
passes' real rows over its device time, in % (device trace)."""
from harness.readers import roofline


def read(run):
    return roofline(run, "flash_attention")
