"""k6_roofline_pct (bit-plane kernels): the stretch's K6 launches' share
of their roofline. Bound: for each layer's three expert projections, one
call a step, the larger of 2 x pairs x K x M at 989 TFLOP/s and the planes
and scales of min(E, pairs) experts with the pairs' bf16 input and f32
output at 3.35 TB/s (bench/work_moe.py); pairs are the rows of the call x
top_k: a decode tick's decoded rows, a prefill's prompt. Device time:
every kernel whose name holds K6's, `bitplane_grouped`, replayed from a
graph or not.

A program without K6 (or a configuration that does not route dropless)
launches no such kernel, and the reader returns None."""

from bench import reduce, work, work_moe

KERNEL = "bitplane_grouped"


def _expert_shapes(m):
    d, f = m["d_model"], m["d_ff"]
    return ((d, f), (d, f), (f, d))


def _call_bound_s(record, pairs: int) -> float:
    m, w = record.model, record.serving["weights"]
    return m["n_layers"] * sum(
        work.bound_s(work_moe.k6_work(pairs, k, n, n_experts=m["n_experts"],
                                      n_bits=w["n_bits"], group=w["group"]))
        for k, n in _expert_shapes(m))


def bound_s(record) -> float:
    top_k = record.model["top_k"]
    total = sum(_call_bound_s(record, len(t.decoded) * top_k)
                for t in record.stretch_ticks() if t.decoded)
    total += sum(_call_bound_s(record, n * top_k)
                 for n in reduce.stretch_prefills(record))
    return total


def read(record):
    t = record.trace
    if t is None or not record.model.get("n_experts"):
        return None
    dev = sum(b - a for name, a, b in t.kernels if KERNEL in name)
    bound = bound_s(record)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
