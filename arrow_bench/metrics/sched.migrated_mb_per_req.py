"""Megabytes (1e6 bytes) of decode state moved per migration in the
window, from the cluster's ``migration_log`` (each transfer's payload
bytes, as the program records them). In the prefill-heavy cells, where a
migration stalls every decoding request's next gap."""
from arrow_bench import readers


def read(run):
    return readers.migrated_mb(run)
