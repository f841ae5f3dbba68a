"""ttft_p90_ms: 90th percentile (nearest rank), over every request due in
the window, of its first token's stamp minus the time it fell due."""

from bench import reduce


def read(record):
    v = reduce.nearest_rank(reduce.ttfts(record), 90)
    return None if v is None else 1e3 * v
