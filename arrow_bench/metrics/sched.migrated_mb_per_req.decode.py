"""``sched.migrated_mb_per_req`` in the decode-heavy cells, where each
migration stops the whole decode batch and so takes from the output
rate."""
from arrow_bench import readers


def read(run):
    return readers.migrated_mb(run)
