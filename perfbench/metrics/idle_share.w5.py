"""idle_share.w5: share of the traced window with no device operation, in %
(device trace)."""
from harness.readers import idle_share


def read(run):
    return idle_share(run)
