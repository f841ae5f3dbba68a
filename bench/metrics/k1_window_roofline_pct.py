"""k1_window_roofline_pct (paged attention kernels): K1's share of its
roofline where layers differ in the keys they read. Bound: one K1 launch
per layer of each decode tick, over every slot (an idle slot holds one
key), each slot reading `min(len, window)` keys: the sliding window on
the windowed layers, the whole table on the global ones
(`local_global_ratio`, as `work_moe.moe_visible_pairs` splits them;
bench/work.py). Device time: every kernel launched inside the
benchmark's `bench/k1` range.

`k1_roofline_pct` counts every layer as global, which over-counts the
windowed layers' keys; a stack without windowed layers reads the same
here and there."""

from bench import reduce, work, work_moe


def bound_s(record) -> float:
    m = record.model
    bs = int(record.serving["block_size"])
    whole = record.table_width * bs
    n_global = work_moe._global_layers(m)
    windows = [(n_global, whole)]
    if m["n_layers"] > n_global:
        windows.append((m["n_layers"] - n_global, m["sliding_window"]))
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    total = 0.0
    for t in record.stretch_ticks():
        if not t.decoded:
            continue
        lengths = [keys for _, keys in t.decoded]
        lengths += [1] * (record.n_slots - len(lengths))
        for layers, window in windows:
            total += layers * work.bound_s(work.k1_work(
                lengths, n_heads=m["n_heads"], head_dim=hd,
                n_kv=m["n_kv_heads"], window=window, block_size=bs,
                table_width=record.table_width))
    return total


def read(record):
    return reduce.roofline_pct(record, "bench/k1", bound_s)
