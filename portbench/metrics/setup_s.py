"""setup_s: process start to the window's start: imports, CUDA start,
the kernel library (built on a checkout's first run), the key's
contexts and comb, the encrypted input pools and the warm-up."""


def read(run):
    return run.setup_s
