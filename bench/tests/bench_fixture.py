"""A checkout of the benchmark with one more cell, made only by adding
files and entries: a configuration (a smoke-size dense decoder), a
traffic mix, a per-layer metric reader and the cell's limits, plus the
cell's `workloads` entry, its metric's entry and the end-to-end metrics
it reports. No file the benchmark has is edited but
`BENCHMARK.json`'s lists.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "fixture-tiny.burst"

TINY = {"name": "fixture-tiny", "family": "dense", "n_layers": 2,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
        "vocab_size": 256, "qkv_bias": True, "tie_embeddings": False,
        "rope_theta": 10000.0, "norm_eps": 1e-5, "act": "silu",
        "mlp_kind": "swiglu", "dtype": "float32"}

TRAFFIC = {"why": "a smoke-size open loop", "loop": "open",
           "rate_per_s": 25.0, "slots": 4,
           "prompt_tokens": {"min": 8, "max": 40},
           "output_tokens": {"min": 3, "max": 9},
           "warm_s": 0.3, "follow_s": 10,
           "check": {"served_tokens": 40}}

READER = '''"""fixture_ticks_per_request (scheduler): ticks of the window per
request due in it."""


def read(record):
    due = record.due_in_window()
    return len(record.window_ticks()) / len(due) if due else None
'''


def make(root: Path, model: dict = None, traffic: dict = None,
         limit: float = 1e-3) -> Path:
    """Copy the benchmark into `root` and add the fixture cell."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = {"name": "fixture-tiny", "source": "smoke size",
            "family": "dense_decoder", "model": dict(model or TINY),
            "serving": {"weights": {"kind": "dense", "dtype": "float32"},
                        "kv_dtype": "bf16", "block_size": 16},
            "control": {"weights": "fp8", "acts": "fp8"},
            "reduced": [], "assumed": []}
    (root / "bench/configs/fixture-tiny.json").write_text(json.dumps(conf))
    (root / "bench/traffic/burst.json").write_text(
        json.dumps(traffic or TRAFFIC))
    (root / "bench/metrics/fixture_ticks_per_request.py").write_text(READER)
    (root / f"bench/limits/{CELL}.json").write_text(
        json.dumps({"widest_gap": {"limit": limit}}))
    spec["configs"].append({"name": "fixture-tiny", "source": "smoke size",
                            "file": "bench/configs/fixture-tiny.json",
                            "reduced": [], "why": "fixture"})
    spec["workloads"].append({"name": CELL, "config": "fixture-tiny",
                              "traffic": "burst", "chips": 1,
                              "why": "fixture"})
    # the open loop's tails: their readers are in `bench/metrics/`
    for name in ("ttft_p90_ms", "itl_p95_ms"):
        spec["end_to_end"].append({
            "name": name, "unit": "ms", "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": [CELL]})
    spec["per_layer"].append({
        "name": "fixture_ticks_per_request", "unit": "ticks",
        "better": "lower", "source": "program_counter", "layer": "scheduler",
        "moves": "ttft_p90_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_cli(root: Path, *args, timeout=300) -> subprocess.CompletedProcess:
    """`python <root>/bench/run.py ... --device cpu` with the program on
    the path, from `root`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, str(root / "bench" / "run.py"), *args,
         "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
