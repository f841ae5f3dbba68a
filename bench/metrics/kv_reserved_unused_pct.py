"""kv_reserved_unused_pct (KV cache and prefix index): pages reserved and
not yet drawn (the program's `pool_free_pages` minus
`pool_unreserved_pages`, read after each tick) over the pool's usable
pages (free plus allocated), mean over the window's ticks. No cell lists it yet:
it needs a traced run that keeps the program's spans (bench/spans.py)."""

from bench import spans


def read(record):
    pools = spans.window_pool(record)
    if not pools:
        return None
    return 100.0 * sum((free - unres) / (free + alloc)
                       for free, unres, alloc in pools) / len(pools)
