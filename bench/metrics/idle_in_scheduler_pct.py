"""idle_in_scheduler_pct (scheduler): share of the profiled stretch in
which the device is idle and the innermost program span is `serve/admit`,
`serve/decode_prep`, `serve/retire` or `serve/tick` itself. No cell lists it yet:
it needs a traced run that keeps the program's spans (bench/spans.py)."""


def read(record):
    s = getattr(record, "idle_split", None)
    return None if s is None else s["scheduler"]
