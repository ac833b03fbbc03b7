"""Seconds from the process's start to the window's start: imports, the
kernels' load (and build, in a checkout's first run), weights, requests,
warm-up."""


def read(run):
    return run.setup_s
