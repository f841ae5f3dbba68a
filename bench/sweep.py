"""Find an open-loop cell's knee: the highest rate whose queue does not
grow over the window. Run once, when the cell is defined, on the chip:

    python3 bench/sweep.py --workload <cell> --rates 2,3,4,5,6 \
        --seconds 45 --seed 5

One set-up; for each rate a fresh batcher on the same weights, the
traffic's warm phase, then `--seconds` of window. One JSON line per rate:
the queue (requests waiting for a slot) at the window's open, middle and
close and its least-squares slope over the window's ticks, requests due
and finished, and the TTFT and ITL tails. The cell then runs at a fixed
fraction of the knee, written into its traffic file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import numpy as np
    import torch

    from bench import loop, reduce, system
    from bench import run as bench_run
    from bench.traffic import Stream

    bench_run._fixed_caches(ROOT)
    torch.set_num_threads(1)
    device = torch.device(args.device)
    cell = bench_run.load_cell(ROOT, args.workload)
    config, base = cell["config"], cell["traffic"]
    model = config["model"]
    params = None
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(base, rate_per_s=rate, follow_s=0)
        if params is None:
            sysm = system.build(config, traffic, bench_run.seed_for_torch(
                args.seed), device)
            params = sysm.batcher.params
        else:
            del sysm
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            sysm = system.rebuild(config, traffic, params, device)
        system.warm(sysm, traffic, model["vocab_size"])
        rec = loop.Record(model=model, serving=config["serving"],
                          traffic=traffic, n_slots=sysm.n_slots,
                          table_width=sysm.table_width, seconds=args.seconds)
        loop.drive(sysm.batcher, sysm.request_cls,
                   Stream(traffic, model["vocab_size"], args.seed), traffic,
                   rec, clock=time.perf_counter)
        w = rec.window_ticks()
        t = np.array([x.t1 - rec.t_open for x in w])
        q = np.array([x.queued for x in w], dtype=float)
        slope = float(np.polyfit(t, q, 1)[0]) if len(w) > 2 else None
        due = rec.due_in_window()
        print(json.dumps({
            "rate_per_s": rate,
            "queue_open_mid_close": [int(q[0]), int(q[len(q) // 2]),
                                     int(q[-1])] if len(q) else None,
            "queue_slope_per_s": slope,
            "due": len(due),
            "finished": sum(r.tokens is not None for r in due),
            "ttft_p90_ms": 1e3 * (reduce.nearest_rank(reduce.ttfts(rec), 90)
                                  or 0.0),
            "itl_p95_ms": 1e3 * (reduce.nearest_rank(
                reduce.token_gaps(rec), 95) or 0.0),
            "ticks": len(w),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
