"""95th percentile of every gap between consecutive output tokens of a
request, over all requests, whose later token landed in the window. A
request's first gap holds its migration to the decode instance."""
from arrow_bench import readers


def read(run):
    v = readers.percentile(readers.token_gaps(run), 95)
    return None if v is None else v * 1e3
