"""k3_decode_roofline_pct (bit-plane kernels): the decode steps' K3 calls'
share of their roofline. Bound: every projection of every layer at the
whole slot batch's rows, once per decode tick of the stretch
(bench/work.py). Device time: every kernel named `bitplane_gemv_kernel`
that was not launched inside the prefill step's range (`bench/prefill`).

The kernel is found by its name, not by the host call that launched it,
so the reading holds whether the decode launches K3 from Python or
replays it from a CUDA graph, which no host range around the kernel's
entry point sees (`k3_roofline_pct` reads those calls only)."""

from bench import work

KERNEL = "bitplane_gemv_kernel"


def _decode_bound_s(record) -> float:
    w = record.serving["weights"]
    if w.get("kind") != "bitplane":
        return 0.0
    m = record.model
    tick = m["n_layers"] * sum(
        work.bound_s(work.bitplane_work(record.n_slots, k, n,
                                        n_bits=w["n_bits"],
                                        group=w["group"]))
        for k, n in work.projections(m))
    return tick * sum(1 for t in record.stretch_ticks() if t.decoded)


def read(record):
    t = record.trace
    if t is None:
        return None
    prefill = {k for call in t.ranges.get("bench/prefill", ()) for k in call}
    dev = sum(b - a for i, (name, a, b) in enumerate(t.kernels)
              if KERNEL in name and i not in prefill)
    bound = _decode_bound_s(record)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
