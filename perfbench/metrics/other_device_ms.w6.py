"""other_device_ms.w6: device ms a traced pass in kernels that are
neither products nor the port's (elementwise and other ATen kernels,
copies; device trace)."""
from harness.readers import group_ms_per_pass


def read(run):
    return group_ms_per_pass(run, "other")
