"""prefill_mfu_pct (serve steps and model): model FLOPs of the prompts
prefilled in the profiled stretch, over the device spans of the prefill
steps (the harness's `bench/prefill` range around each: first kernel's
start to last kernel's end) and 989 TFLOP/s."""

from bench import reduce, work


def read(record):
    t = record.trace
    if t is None or not t.kernels:
        return None
    span = sum(t.spans_s("bench/prefill"))
    flops = reduce.stretch_model_flops(record, prefill_only=True)
    if span <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (span * work.PEAK_BF16_FLOPS)
