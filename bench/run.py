"""Run one cell of `BENCHMARK.json` once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `bench/` and the
program under `src/`. Set-up (process start to ready to serve: weights
drawn from the seed on the card, packed when the configuration serves
bit-plane weights, kernels built or loaded, the cell's step shapes run
once), then the traffic's warm phase, then `--seconds` of measured
window, then the output check against the plain reference. The last line
of standard output is one JSON object; the numbers the check compared
close standard error. With `--trace 1` the traffic goes on after the
window for a stretch under `torch.profiler`, and the line carries the
cell's per-layer metrics.

`--device cpu` runs the same path on the CPU with the kernels' plain
versions; it exists for the tests and is never what a cell measures.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                              # noqa: E402
import gc                                                    # noqa: E402
import importlib.util                                        # noqa: E402
import json                                                  # noqa: E402
import os                                                    # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the JAX reference package and its stack: a run loads none of them
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fixed_caches(root: Path) -> None:
    """Every cache the run could write stays inside the checkout, at a
    fixed path."""
    build = root / "build"
    os.environ["CUDA_CACHE_PATH"] = str(build / "bench_cuda_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "bench_torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "bench_triton_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_reader(root: Path, name: str):
    """`bench/metrics/<name>.py`'s `read`. A metric split by the cells it
    is read in (`<measure>.<part>`, each with its own `moves`) falls back
    to the measure's reader `bench/metrics/<measure>.py`."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = root / "bench" / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, found
    by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((root / "bench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((root / "bench" / "limits"
                              / f"{workload}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def seed_for_torch(seed: int) -> int:
    """A 63-bit generator seed from any whole number."""
    import numpy as np
    return int(np.random.SeedSequence(seed).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def run(root: Path, cell: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: bool = False) -> dict:
    """One run of `cell`; returns the result object (without printing).
    `control` also reads the control on the same sample (`bench/control.py`;
    a cell's runs never do)."""
    import torch

    from bench import check, loop, system
    from bench.trace import Tracer
    from bench.traffic import Stream

    config, traffic = cell["config"], cell["traffic"]
    model = config["model"]
    seed %= 1 << 64                  # any whole number, negative ones too
    wseed = seed_for_torch(seed)
    clock = time.perf_counter
    sysm = system.build(config, traffic, wseed, device)
    system.warm(sysm, traffic, model["vocab_size"])
    record = loop.Record(model=model, serving=config["serving"],
                         traffic=traffic, n_slots=sysm.n_slots,
                         table_width=sysm.table_width, seconds=seconds)
    hook = None
    if trace:
        # the stamps of admission run all along (a dict write each); the
        # profiler and the kernel ranges only in the stretch, after the
        # window, so no tick the window is judged on carries their cost
        system.watch_batcher(sysm.batcher, clock, record.admit_ts)
        hook = _Stretch(Tracer(device),
                        system.Ranges(record.bitplane_calls), clock)
    # what set-up made lives as long as the run: out of the collector's
    # scans, as a long-running server would keep it
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record.setup_s = clock() - t_start
    print(f"[setup] {record.setup_s:.3f} s", file=sys.stderr, flush=True)

    stream = Stream(traffic, model["vocab_size"], seed)
    window = _Window(sysm.batcher, device, record)
    loop.drive(sysm.batcher, sysm.request_cls, stream, traffic, record,
               clock=clock, tracer=hook, window=window)
    w = record.window_ticks()
    print(f"[traffic] warm {record.t_open - record.ticks[0].t0:.3f} s, "
          f"window {record.t_close - record.t_open:.3f} s over {len(w)} "
          f"ticks, {len(record.reqs)} requests drawn, queue "
          f"{w[0].queued if w else 0} -> {w[-1].queued if w else 0}, "
          f"generator late by at most {record.lateness_max_s:.4f} s",
          file=sys.stderr, flush=True)
    walls = [t.t1 - t.t0 for t in w if t.decoded and not t.first]
    if walls:
        print(f"[ticks] {len(walls)} decode-only ticks in the window, "
              f"mean {1e3 * sum(walls) / len(walls):.3f} ms",
              file=sys.stderr, flush=True)
    kv = window.kv_report()
    print(f"[memory] peak {record.memory_peak_bytes} B in the window; KV "
          f"pool {kv['pages_reserved']} pages reserved "
          f"({kv['bytes_reserved']} B), at most {kv['pages_peak']} in use "
          f"({kv['bytes_peak']} B); {window.gc_collections} collections, "
          f"load average {window.load[0]} -> {window.load[1]}",
          file=sys.stderr, flush=True)
    if hook is not None:
        t_reduce = clock()
        record.trace = hook.tracer.reduce()
        t_reduce = clock() - t_reduce
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    # the output check: the program's state goes first
    del sysm
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if traffic["loop"] == "open":
        attempted = record.due_in_window()
    else:
        attempted = record.finished_in_window()
    failed = [r for r in attempted if r.tokens is None]
    short = [r for r in attempted
             if r.tokens is not None and len(r.tokens) != r.max_new]
    picked = check.sample([r for r in attempted if r.tokens is not None],
                          int(traffic["check"]["served_tokens"]), seed)
    family = system.load_family(config["family"])
    judged = check.judge(family, config, wseed, picked, device)
    limits = cell["limits"]
    checks = {
        "widest_gap": {"value": judged["widest_gap"],
                       "limit": limits["widest_gap"]["limit"]},
        "short_tokens": {"value": len(short), "limit": 0},
    }
    if control and picked:
        ctl = cell["config"]["control"]
        cg = check.control_gaps(family, config, wseed, picked,
                                judged["logits"], device,
                                ctl["weights"], ctl.get("acts"))
        judged["control"] = {"widest_gap": float(cg.max()),
                             "mean_gap": float(cg.mean())}
    del judged["logits"]
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    print(f"[check] {judged['sampled_requests']} requests, "
          f"{judged['sampled_tokens']} served tokens sampled, mean gap "
          f"{judged['mean_gap']}", file=sys.stderr)

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = load_reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["cell"]["chips"]),
           "memory_peak_bytes": record.memory_peak_bytes,
           "kv_pool": kv}
    result = {"correct": correct, "attempted": len(attempted),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        t = record.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
        print(f"[trace] {len(t.kernels)} device activities, "
              f"{t.unattributed} not tied to a host launch, stretch of "
              f"ticks {record.stretch}, profiler stopped in "
              f"{hook.stop_s:.3f} s, reduced in {t_reduce:.3f} s",
              file=sys.stderr)
    if "control" in judged:
        result["control"] = judged["control"]
        result["program"] = {"widest_gap": judged["widest_gap"],
                             "mean_gap": judged["mean_gap"]}
    result["checks"] = checks
    return result


class ForbiddenImport(RuntimeError):
    pass


class _Window:
    """What the run reads at the window's edges and after each of its
    ticks: the device memory peak of the window alone (the peak is reset
    at its open, so set-up's transients are not in it), the KV pool's
    pages in use against those reserved, the collector's passes and the
    host's load average."""

    def __init__(self, batcher, device, record):
        self.pools = batcher.pcache.pools
        self.device, self.record = device, record
        pc = batcher.pcache
        n_layers = pc.k_pages.shape[0]
        self._page_bytes = [
            (pc.k_pages.nbytes + pc.v_pages.nbytes) * len(p.layers)
            // (n_layers * pc.n_blocks) for p in self.pools]
        self.pages_peak = 0
        self.gc_collections = 0
        self.load = (None, None)

    def _in_use(self):
        return [p.allocated_pages() for p in self.pools]

    def open(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.pages_peak = sum(self._in_use())
        self._gc0 = sum(s["collections"] for s in gc.get_stats())
        self.load = (_loadavg(), None)

    def tick(self):
        self.pages_peak = max(self.pages_peak, sum(self._in_use()))

    def close(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.record.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        self.gc_collections = (sum(s["collections"] for s in gc.get_stats())
                               - self._gc0)
        self.load = (self.load[0], _loadavg())

    def kv_report(self) -> dict:
        reserved = [p.n_blocks - 1 for p in self.pools]   # page 0: scratch
        per_page = self._page_bytes[0] if len(self.pools) == 1 else None
        return {"pages_reserved": sum(reserved),
                "pages_peak": self.pages_peak,
                "bytes_reserved": sum(n * b for n, b in
                                      zip(reserved, self._page_bytes)),
                "bytes_peak": (self.pages_peak * per_page
                               if per_page is not None else None)}


def _loadavg():
    try:
        return os.getloadavg()[0]
    except OSError:
        return None


class _Stretch:
    """Starts the profiler and the kernel ranges for the traced stretch,
    and takes them away after it."""

    def __init__(self, tracer, ranges, clock):
        self.tracer, self.ranges, self.clock = tracer, ranges, clock
        self.stop_s = 0.0

    def start(self):
        self.ranges.install()
        self.ranges.recording = True
        self.tracer.start()

    def stop(self):
        t = self.clock()
        self.tracer.stop()
        self.ranges.recording = False
        self.ranges.remove()
        self.stop_s = self.clock() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _fixed_caches(ROOT)
    cell = load_cell(ROOT, args.workload)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    torch.set_num_threads(1)
    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(cell["cell"]["chips"]):
            print(f"bench: the cell needs {cell['cell']['chips']} CUDA "
                  f"device(s), this machine has {n}", file=sys.stderr)
            return 3
    try:
        result = run(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                     torch.device(args.device), T_START)
    except ForbiddenImport as e:
        print(f"bench: the run loaded {e.args[0]}, which the port must "
              "not use", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}, which the port must not use",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
