"""Set-up: from the process's start to the window's first batch (imports,
CUDA's start, the kernels' library loaded or built, the weights made, the
server built, one warm prefill and the decode graph's capture), in s."""


def read(run):
    return run.setup_s
