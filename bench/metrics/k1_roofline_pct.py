"""k1_roofline_pct (paged attention kernels): bound time of the stretch's
K1 launches (bench/work.py) over the device time of every kernel
launched inside the benchmark's `bench/k1` range."""

from bench import reduce


def read(record):
    return reduce.roofline_pct(record, "bench/k1", reduce.k1_bound_s)
