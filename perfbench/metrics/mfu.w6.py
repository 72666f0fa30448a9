"""mfu.w6: useful flops completed in the window over its length, as a share
of the peak rate, in % (host clock and flops/)."""
from harness.readers import mfu_window


def read(run):
    return mfu_window(run)
