"""decode_rows_mean (scheduler): slots whose request gained a decoded
token, per tick of the window."""


def read(record):
    ticks = record.window_ticks()
    if not ticks:
        return None
    return sum(len(t.decoded) for t in ticks) / len(ticks)
