"""itl_p95_ms: 95th percentile (nearest rank) over every gap between
consecutive token stamps of the requests due in the window."""

from bench import reduce


def read(record):
    v = reduce.nearest_rank(reduce.token_gaps(record), 95)
    return None if v is None else 1e3 * v
