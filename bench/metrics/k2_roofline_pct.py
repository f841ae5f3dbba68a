"""k2_roofline_pct (paged attention kernels): bound time of the stretch's
K2 launches (bench/work.py) over the device time of every kernel
launched inside the benchmark's `bench/k2` range."""

from bench import reduce


def read(record):
    return reduce.roofline_pct(record, "bench/k2", reduce.k2_bound_s)
