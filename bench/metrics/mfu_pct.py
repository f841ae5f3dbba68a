"""mfu_pct (device, the whole step): model FLOPs of every token computed
in the profiled stretch (prompts with their logits row, decoded tokens
with the keys they saw; bit-plane weights counted as the dense product),
over the stretch's seconds and 989 TFLOP/s."""

from bench import reduce, work


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    flops = reduce.stretch_model_flops(record)
    return 100.0 * flops / (t.window_s * work.PEAK_BF16_FLOPS)
