"""decode_tick_ms (serve steps and model): mean wall of the window's ticks
that decoded and prefilled nothing, in the saturated cell."""

from bench import reduce


def read(record):
    v = reduce.decode_only_tick_s(record)
    return None if v is None else 1e3 * v
