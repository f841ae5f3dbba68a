"""k3_attn_decode_roofline_pct (bit-plane kernels): the decode steps' K3
calls' share of their roofline in a stack whose experts run on K6, so
that K3 runs the attention projections alone. Bound: the four attention
projections (q, k, v, o) of every layer at the whole slot batch's rows,
once per decode tick of the stretch (bench/work.py). Device time: every
kernel named `bitplane_gemv_kernel` that was not launched inside the
prefill step's range (`bench/prefill`), replayed from a CUDA graph or
not, as `k3_decode_roofline_pct` finds it.

`k3_decode_roofline_pct` counts the MLP's projections too, at one
expert's width, which K3 does not run in such a stack."""

from bench import work

KERNEL = "bitplane_gemv_kernel"
#: q, k, v, o: the first four of `work.projections`
ATTENTION = 4


def bound_s(record) -> float:
    w = record.serving["weights"]
    if w.get("kind") != "bitplane":
        return 0.0
    m = record.model
    tick = m["n_layers"] * sum(
        work.bound_s(work.bitplane_work(record.n_slots, k, n,
                                        n_bits=w["n_bits"],
                                        group=w["group"]))
        for k, n in work.projections(m)[:ATTENTION])
    return tick * sum(1 for t in record.stretch_ticks() if t.decoded)


def read(record):
    t = record.trace
    if t is None:
        return None
    prefill = {k for call in t.ranges.get("bench/prefill", ()) for k in call}
    dev = sum(b - a for i, (name, a, b) in enumerate(t.kernels)
              if KERNEL in name and i not in prefill)
    bound = bound_s(record)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
