"""idle_in_dispatch_pct (serve steps and model): share of the profiled
stretch in which the device is idle and the innermost program span is a
step call (`serve/paged_decode`, `serve/paged_prefill`). No cell lists it yet:
it needs a traced run that keeps the program's spans (bench/spans.py)."""


def read(record):
    s = getattr(record, "idle_split", None)
    return None if s is None else s["dispatch"]
