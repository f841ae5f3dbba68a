"""queue_wait_p95_ms (scheduler): 95th percentile (nearest rank), over the
requests due in the window, of the moment the batcher seated the request
in a slot (the harness's stamp at that call, traced runs) minus the time
it fell due. One never admitted counts as waiting until the run ended."""

from bench import reduce


def read(record):
    if not record.admit_ts:
        return None
    waits = [record.admit_ts.get(r.uid, record.t_end) - r.due
             for r in record.due_in_window()]
    v = reduce.nearest_rank(waits, 95)
    return None if v is None else 1e3 * v
