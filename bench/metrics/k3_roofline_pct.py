"""k3_roofline_pct (bit-plane kernels): bound time of the stretch's K3
calls, from the rows, K and M each was given (bench/work.py), over the
device time of every kernel launched inside the `bench/k3` range."""

from bench import reduce


def read(record):
    return reduce.roofline_pct(
        record, "bench/k3", lambda r: reduce.bitplane_bound_s(r, "bench/k3"))
