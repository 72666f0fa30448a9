"""throughput_rps.w6: requests answered in the window over its length (host
clock; the window ends with the last pump that started inside it)."""


def read(run):
    w = run.window
    span = w.close - w.t0
    return len(w.in_window()) / span if span > 0 else None
