"""90th percentile of the time to first token of every request due in the
window, timed from its due time; a request without a first token when the
window closes enters with its wait so far, so a stall cannot shrink the
sample."""
from arrow_bench import readers


def read(run):
    v = readers.percentile(readers.ttfts(run), 90)
    return None if v is None else v * 1e3
