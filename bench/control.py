"""Read the output check's two ends for a cell: the program's widest gap
and the control's, on several seeds in one process.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 15

Each seed is a whole run of the cell at its own size and load (a short
window), whose sample is then also read by the control: the plain
reference at the precision below the configuration's (`control` in the
configuration's file). One JSON line per seed. The cell's own runs never
read the control; this tool sets the limits of `bench/limits/<cell>.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench import run as bench_run
    bench_run._fixed_caches(ROOT)
    torch.set_num_threads(1)
    cell = bench_run.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = bench_run.run(ROOT, cell, seed, args.seconds, False,
                            torch.device(args.device), time.perf_counter(),
                            control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "program": res.get("program"),
                          "control": res.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
