"""The mixture-of-experts yardstick: `bench/work_moe.py` equal to the
program's closed forms (`repro_torch/kernels/work.py`), and the readers
`k6_roofline_pct` and `moe_mfu_pct` on synthetic traced records."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench import run as bench_run
from bench import work, work_moe
from bench.loop import Record, Req, Tick
from bench.trace import Trace
from repro_torch.kernels import work as program_work

REPO = Path(__file__).resolve().parents[2]
MODEL = json.loads((REPO / "bench" / "configs"
                    / "mellum2-12b-a2.5b-pim8.json").read_text())["model"]
PIM8 = {"kind": "bitplane", "n_bits": 8, "group": 1}
K6 = "void bitplane::bitplane_grouped_kernel<__nv_bfloat16, 1>(...)"


@pytest.mark.parametrize("pairs,k,m,e", [(1024, 2304, 896, 64),
                                         (1024, 896, 2304, 64),
                                         (11080, 2304, 896, 64),
                                         (24, 32, 24, 8)])
def test_k6_work_matches_program(pairs, k, m, e):
    assert (work_moe.k6_work(pairs, k, m, n_experts=e)
            == program_work.k6_work(pairs, k, m, n_experts=e))


@pytest.mark.parametrize("n", [1, 300, 1024, 1025, 4096])
def test_model_flops_match_program(n):
    assert work_moe.moe_token_flops(MODEL) == program_work.moe_token_flops(
        MODEL)
    assert (work_moe.moe_prefill_flops(MODEL, n)
            == program_work.moe_prefill_flops(MODEL, n))
    assert (work_moe.moe_decode_flops(MODEL, n)
            == program_work.moe_decode_flops(MODEL, n))


def test_visible_pairs_by_layer_kind():
    """7 global layers see the whole prefix, 21 windowed ones at most
    1024 keys."""
    assert work_moe.moe_visible_pairs(MODEL, 4095, 4096) == 7 * 4096 + \
        21 * 1024
    assert work_moe.moe_visible_pairs(MODEL, 0, 2048) == (
        7 * 2048 * 2049 // 2 + 21 * (1024 * 1025 // 2 + 1024 * 1024))


def reader(name):
    return bench_run.load_reader(REPO, name)


def record(kernels, rows=128, prompt=1024, window_s=0.1):
    """Two decode ticks of `rows` decoded rows and one tick that
    prefilled a `prompt`-token request, over `kernels`."""
    r = Record(model=dict(MODEL), serving={"block_size": 16,
                                           "weights": PIM8},
               traffic={}, n_slots=128, table_width=320, seconds=10.0)
    r.reqs = {999: Req(uid=999, prompt=np.zeros(prompt, np.int32),
                       max_new=4, due=0.0)}
    r.ticks = [Tick(0.0, 1.0, [], [(u, 1500) for u in range(rows)], 0)
               for _ in range(2)]
    r.ticks.append(Tick(1.0, 2.0, [999], [], 0))
    r.stretch = (0, 3)
    r.trace = Trace(window_s=window_s, busy_s=window_s / 2, kernels=kernels,
                    ranges={}, unattributed=0, device_ops=[], idle_gaps=[])
    return r


def call_bound_s(pairs):
    return MODEL["n_layers"] * sum(
        work.bound_s(work_moe.k6_work(pairs, k, m, n_experts=64))
        for k, m in ((2304, 896), (2304, 896), (896, 2304)))


def test_k6_roofline_reads_every_k6_kernel():
    kernels = [(K6, 0.0, 4e-3), (K6, 4e-3, 5e-3),
               ("bitplane_gemv_kernel", 5e-3, 6e-3),
               ("paged_decode_kernel", 6e-3, 7e-3)]
    got = reader("k6_roofline_pct")(record(kernels))
    want = 2 * call_bound_s(128 * 8) + call_bound_s(1024 * 8)
    assert got == pytest.approx(100.0 * want / 5e-3)


def test_k6_roofline_stays_under_100_with_every_expert_touched():
    """Device time at the bound gives 100%; a kernel that streams every
    expert's planes once per call and the pairs' rows can take no less,
    so a real reading lies below."""
    want = 2 * call_bound_s(128 * 8) + call_bound_s(1024 * 8)
    got = reader("k6_roofline_pct")(record([(K6, 0.0, want)]))
    assert got == pytest.approx(100.0)
    # every expert has rows at 1024 pairs: the bytes are all 64 experts'
    one = work_moe.k6_work(1024, 2304, 896, n_experts=64)[1]
    planes = 64 * (8 * 288 * 896 + 4 * 896)
    assert one == planes + 1024 * 2304 * 2 + 1024 * 896 * 4


def test_moe_mfu_known_value_and_below_100():
    kernels = [(K6, 0.0, 1e-3)]
    r = record(kernels)
    flops = (work_moe.moe_prefill_flops(MODEL, 1024)
             + 2 * 128 * work_moe.moe_decode_flops(MODEL, 1500))
    got = reader("moe_mfu_pct")(r)
    assert got == pytest.approx(100.0 * flops / (0.1 * work.PEAK_BF16_FLOPS))
    assert 0 < got < 100


def test_nothing_to_read():
    assert reader("k6_roofline_pct")(record([("paged_decode_kernel", 0.0,
                                               1e-3)])) is None
    r = record([(K6, 0.0, 1e-3)])
    r.trace = None
    assert reader("k6_roofline_pct")(r) is None
    assert reader("moe_mfu_pct")(r) is None


def k1_bound_s(model, lengths, window):
    return work.bound_s(work.k1_work(
        lengths, n_heads=model["n_heads"], head_dim=model["head_dim"],
        n_kv=model["n_kv_heads"], window=window, block_size=16,
        table_width=320))


def test_k1_window_roofline_counts_keys_by_layer_kind():
    """7 global layers read each slot's whole 1500 keys, 21 windowed ones
    1024; the two decode ticks' K1 launches inside `bench/k1` are the
    device time, and the prefill's kernels are not."""
    kernels = [("paged_decode_kernel", 0.0, 2e-3),
               ("paged_decode_kernel", 2e-3, 3e-3),
               ("paged_prefill_kernel", 3e-3, 9e-3)]
    r = record(kernels)
    r.trace.ranges = {"bench/k1": [[0], [1]], "bench/k2": [[2]]}
    lengths = [1500] * 128
    want = 2 * (7 * k1_bound_s(MODEL, lengths, 320 * 16)
                + 21 * k1_bound_s(MODEL, lengths, 1024))
    got = reader("k1_window_roofline_pct")(r)
    assert got == pytest.approx(100.0 * want / 3e-3)
    # every layer counted as global reads more keys than K1 is given
    assert reader("k1_roofline_pct")(r) > got


def test_k1_window_roofline_equals_k1_roofline_without_windows():
    dense = dict(MODEL, local_global_ratio=0, sliding_window=0)
    r = record([("paged_decode_kernel", 0.0, 2e-3)])
    r.model = dense
    r.trace.ranges = {"bench/k1": [[0]]}
    assert reader("k1_window_roofline_pct")(r) == pytest.approx(
        reader("k1_roofline_pct")(r))


def test_k3_attn_decode_roofline_counts_attention_projections():
    """Bound: q, k, v, o of 28 layers at 128 rows for each of the two
    decode ticks; K3 kernels inside the prefill's range are left out, and
    K6 is not K3."""
    k3 = "void bitplane::bitplane_gemv_kernel<__nv_bfloat16, 1>(...)"
    kernels = [(k3, 0.0, 1e-3), (k3, 1e-3, 3e-3), (k3, 3e-3, 8e-3),
               (K6, 8e-3, 9e-3)]
    r = record(kernels)
    r.trace.ranges = {"bench/prefill": [[2, 3]]}
    attn = ((2304, 4096), (2304, 512), (2304, 512), (4096, 2304))
    want = 2 * 28 * sum(work.bound_s(work.bitplane_work(128, k, m))
                        for k, m in attn)
    got = reader("k3_attn_decode_roofline_pct")(r)
    assert got == pytest.approx(100.0 * want / 3e-3)
    assert 0 < got < reader("k3_decode_roofline_pct")(r)


def test_new_readers_find_nothing_to_read():
    r = record([(K6, 0.0, 1e-3)])
    assert reader("k1_window_roofline_pct")(r) is None
    assert reader("k3_attn_decode_roofline_pct")(r) is None
    r.trace = None
    assert reader("k1_window_roofline_pct")(r) is None
    assert reader("k3_attn_decode_roofline_pct")(r) is None
