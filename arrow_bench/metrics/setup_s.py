"""Seconds from the process's start to the start of traffic: imports, the
kernels' libraries (built in the checkout's cache on a first run), the
weights, the cluster with its prefill profiling, and the warm-up of this
cell's shapes. The pre-roll is not in it."""


def read(run):
    return run.setup_s
