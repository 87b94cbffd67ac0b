"""``device.idle_frac`` in the decode-heavy cells: the share of the
profiled slice's engine time in which nothing ran on the device."""
from arrow_bench import readers


def read(run):
    return readers.idle_frac(run)
