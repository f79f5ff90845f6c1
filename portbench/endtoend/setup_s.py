"""Set-up seconds: process start to the window's start (imports, CUDA start, kernel loads, inputs, warm-up)."""


def read(run):
    return run.setup_s
