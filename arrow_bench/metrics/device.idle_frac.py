"""Share of the profiled slice's engine time (the harness's ``step()``
calls that dispatched or finalized work) in which nothing ran on the
device: how far the host holds the card back while it has work."""
from arrow_bench import readers


def read(run):
    return readers.idle_frac(run)
