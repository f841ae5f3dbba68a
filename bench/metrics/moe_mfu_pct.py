"""moe_mfu_pct (device, the whole step): active-parameter model FLOPs of
every token computed in the profiled stretch, over the stretch's seconds
and 989 TFLOP/s. A token goes through the attention projections, the
router, its top_k experts and the head; attention counts the visible
(query, key) pairs, the window's on the sliding layers
(bench/work_moe.py). Bit-plane weights count as the dense product."""

from bench import reduce, work, work_moe


def read(record):
    t = record.trace
    m = record.model
    if t is None or t.window_s <= 0 or not t.kernels or not m.get(
            "n_experts"):
        return None
    flops = sum(work_moe.moe_prefill_flops(m, n)
                for n in reduce.stretch_prefills(record))
    flops += sum(work_moe.moe_decode_flops(m, keys)
                 for tk in record.stretch_ticks() for _, keys in tk.decoded)
    return 100.0 * flops / (t.window_s * work.PEAK_BF16_FLOPS)
