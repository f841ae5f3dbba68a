"""output_tokens_per_s: every token stamped inside the window, over the
window's seconds (it opens and closes on tick stamps)."""


def read(record):
    n = sum(1 for r in record.reqs.values() for s in r.stamps
            if record.t_open < s <= record.t_close)
    return n / (record.t_close - record.t_open)
