"""device_idle_pct (device): share of the profiled stretch with no device
activity running, in the saturated cell."""

from bench import reduce


def read(record):
    return reduce.idle_pct(record)
