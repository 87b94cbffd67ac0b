"""``engine.pass_ms`` in the decode-heavy cells, where the pass time sets
how fast the full decode batch emits tokens."""
from arrow_bench import readers


def read(run):
    return readers.pass_ms(run)
