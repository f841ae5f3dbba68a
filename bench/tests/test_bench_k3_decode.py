"""`k3_decode_roofline_pct` on synthetic traced records: the decode steps'
K3 kernels found by name, the prefill step's left out, whether or not a
host range saw their launch."""

from pathlib import Path

from bench import run as bench_run
from bench import work
from bench.loop import Record, Tick
from bench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 1,
         "d_ff": 256, "vocab_size": 100, "mlp_kind": "plain"}
PIM8 = {"kind": "bitplane", "n_bits": 8, "group": 1}
K3 = "void bitplane::bitplane_gemv_kernel<8, 1>(...)"


def reader():
    return bench_run.load_reader(REPO, "k3_decode_roofline_pct")


def record(kernels, ranges, weights=PIM8, decode_ticks=3):
    """A stretch of `decode_ticks` decode ticks and one prefill-only
    tick, over `kernels` (name, start, end) and host `ranges`."""
    r = Record(model=dict(MODEL), serving={"block_size": 16,
                                           "weights": weights},
               traffic={}, n_slots=8, table_width=8, seconds=10.0)
    r.ticks = [Tick(0.0, 1.0, [], [(u, 5) for u in range(8)], 0)
               for _ in range(decode_ticks)]
    r.ticks.append(Tick(1.0, 2.0, [9], [], 0))
    r.stretch = (0, len(r.ticks))
    r.trace = Trace(window_s=2.0, busy_s=1.0, kernels=kernels, ranges=ranges,
                    unattributed=0, device_ops=[], idle_gaps=[])
    return r


def tick_bound_s():
    return MODEL["n_layers"] * sum(
        work.bound_s(work.bitplane_work(8, k, m, n_bits=8, group=1))
        for k, m in work.projections(MODEL))


def test_decode_k3_by_name_prefill_left_out():
    kernels = [(K3, 0.0, 1e-3),               # decode, eager
               (K3, 1e-3, 3e-3),              # decode, replayed: no range
               (K3, 3e-3, 7e-3),              # prefill
               ("paged_decode_kernel", 7e-3, 8e-3),
               ("aten::mm", 8e-3, 9e-3)]
    ranges = {"bench/k3": [[0], [2]], "bench/prefill": [[2]],
              "bench/k1": [[3]]}
    got = reader()(record(kernels, ranges))
    assert got == 100.0 * 3 * tick_bound_s() / 3e-3


def test_the_same_kernels_read_alike_with_and_without_their_range():
    kernels = [(K3, 0.0, 2e-3), (K3, 2e-3, 4e-3)]
    eager = reader()(record(kernels, {"bench/k3": [[0], [1]]}))
    replayed = reader()(record(kernels, {}))
    assert eager == replayed > 0


def test_nothing_to_read():
    read = reader()
    assert read(record([], {})) is None
    prefill_only = [(K3, 0.0, 1e-3)]
    assert read(record(prefill_only, {"bench/prefill": [[0]]})) is None
    assert read(record([(K3, 0.0, 1e-3)], {}, decode_ticks=0)) is None
    dense = {"kind": "bf16"}
    assert read(record([(K3, 0.0, 1e-3)], {}, weights=dense)) is None
    r = record([(K3, 0.0, 1e-3)], {})
    r.trace = None
    assert read(r) is None
