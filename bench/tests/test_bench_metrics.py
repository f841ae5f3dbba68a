"""The metric arithmetic on synthetic stamps: window edges, requests that
never got a first token, nearest-rank tails, tick walls."""

from pathlib import Path

import numpy as np
import pytest

from bench import reduce
from bench import run as bench_run
from bench.loop import Record, Req, Tick

REPO = Path(__file__).resolve().parents[2]


def reader(name):
    return bench_run.load_reader(REPO, name)


def rec():
    r = Record(model={}, serving={"block_size": 16}, traffic={}, n_slots=4,
               table_width=8, seconds=10.0)
    r.t_open, r.t_close, r.t_end = 100.0, 110.0, 130.0
    return r


def req(uid, due, stamps, max_new=None):
    r = Req(uid=uid, prompt=np.zeros(5, np.int32),
            max_new=max_new or len(stamps), due=due)
    r.stamps = list(stamps)
    return r


def test_nearest_rank():
    vals = list(range(1, 21))                   # 1..20
    assert reduce.nearest_rank(vals, 90) == 18
    assert reduce.nearest_rank(vals, 95) == 19
    assert reduce.nearest_rank(vals, 100) == 20
    assert reduce.nearest_rank([7.0], 95) == 7.0
    assert reduce.nearest_rank([], 90) is None
    assert reduce.nearest_rank(list(range(1, 11)), 90) == 9


def test_ttft_window_edges_and_missing_first_tokens():
    r = rec()
    r.reqs = {
        0: req(0, 99.999, [100.5]),             # due before the window
        1: req(1, 100.0, [100.2, 100.3]),       # due at the open: in
        2: req(2, 109.9, [110.4]),              # due inside, served after
        3: req(3, 110.0, [110.1]),              # due at the close: out
        4: req(4, 105.0, []),                   # never served
    }
    got = sorted(reduce.ttfts(r))
    assert got == pytest.approx(sorted([0.2, 110.4 - 109.9, 130.0 - 105.0]))
    # nearest rank of three: p90 is the largest, the unserved one
    assert reader("ttft_p90_ms")(r) == pytest.approx(25_000.0)


def test_itl_gaps_of_requests_due_in_window():
    r = rec()
    r.reqs = {0: req(0, 99.0, [100.0, 100.5, 101.0]),   # not due in window
              1: req(1, 101.0, [102.0, 102.1, 102.1, 102.4])}
    assert sorted(reduce.token_gaps(r)) == pytest.approx([0.0, 0.1, 0.3])
    assert reader("itl_p95_ms")(r) == pytest.approx(300.0)


def test_output_tokens_per_s_counts_stamps_in_the_open_interval():
    r = rec()
    r.reqs = {0: req(0, 0, [100.0, 100.5, 110.0, 110.5]),
              1: req(1, 0, [105.0])}
    # (100, 110]: 100.5, 110.0, 105.0
    assert reader("output_tokens_per_s")(r) == pytest.approx(3 / 10.0)


def test_tick_walls_and_decode_rows():
    r = rec()
    r.ticks = [Tick(99.0, 100.0, [], [(0, 5)], 0),     # before the window
               Tick(100.0, 100.2, [], [(0, 6), (1, 9)], 0),
               Tick(100.2, 100.7, [2], [(0, 7)], 0),   # also prefilled
               Tick(100.7, 100.8, [3], [], 0),         # only prefilled
               Tick(100.8, 101.2, [], [(0, 8)], 1),
               Tick(110.0, 110.3, [], [(0, 9)], 0)]    # after the close
    assert reader("decode_tick_ms.itl")(r) == pytest.approx(300.0)
    assert reader("decode_tick_ms")(r) == pytest.approx(300.0)
    assert reader("decode_rows_mean")(r) == pytest.approx(4 / 4)


def test_queue_wait_uses_admission_stamps():
    r = rec()
    r.reqs = {i: req(i, 100.0 + i, [100.0 + i + 1]) for i in range(5)}
    r.admit_ts = {0: 100.1, 1: 101.2, 2: 102.3, 3: 103.4}   # 4 never
    assert reader("queue_wait_p95_ms")(r) == pytest.approx(26_000.0)
    r.admit_ts = {}
    assert reader("queue_wait_p95_ms")(r) is None


def test_device_readers_find_nothing_without_a_trace():
    r = rec()
    for name in ("k1_roofline_pct", "k2_roofline_pct", "k3_roofline_pct",
                 "prefill_mfu_pct", "mfu_pct", "device_idle_pct",
                 "device_idle_pct.ttft"):
        assert reader(name)(r) is None


def test_a_split_metric_name_falls_back_to_its_measures_reader(tmp_path):
    metrics = tmp_path / "bench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "ticks.py").write_text("def read(record):\n    return 1\n")
    (metrics / "ticks.own.py").write_text("def read(record):\n    return 2\n")
    load = bench_run.load_reader
    assert load(tmp_path, "ticks")(None) == 1
    assert load(tmp_path, "ticks.serve")(None) == 1
    assert load(tmp_path, "ticks.own")(None) == 2
    with pytest.raises(FileNotFoundError):
        load(tmp_path, "other.serve")
