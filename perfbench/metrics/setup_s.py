"""setup_s: the process's start to the window's first request: torch and CUDA,
the kernels' library (built on a first run), the weights, the engine and its
warm-up (host clock)."""


def read(run):
    return run.setup_s
