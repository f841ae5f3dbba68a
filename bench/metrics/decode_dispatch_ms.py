"""decode_dispatch_ms (serve steps and model): mean length of the
program's `serve/paged_decode` span (the decode step call: the host
enqueueing every layer) over the window's ticks that decoded and
prefilled nothing. No cell lists it yet:
it needs a traced run that keeps the program's spans (bench/spans.py)."""

from bench import spans


def read(record):
    lengths = [s.end_ns - s.start_ns
               for sp in spans.window_spans(record, decode_only=True)
               for s in sp if s.name == "serve/paged_decode"]
    return 1e-6 * sum(lengths) / len(lengths) if lengths else None
