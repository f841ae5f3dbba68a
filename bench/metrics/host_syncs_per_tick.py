"""host_syncs_per_tick (serve steps and model): the program's
`serve/sync` and `serve/first_token` spans (the host waiting for the
card) per window tick. No cell lists it yet:
it needs a traced run that keeps the program's spans (bench/spans.py)."""

from bench import spans


def read(record):
    ticks = spans.window_spans(record)
    if not ticks:
        return None
    return sum(s.name in spans.SYNCS for sp in ticks for s in sp) / len(ticks)
