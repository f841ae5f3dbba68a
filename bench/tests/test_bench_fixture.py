"""A cell added with new files and entries only runs end to end on the CPU
at smoke size, untraced and traced, and reports its new metric."""

import json

import pytest

from bench.tests import bench_fixture


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_fixture.make(tmp_path_factory.mktemp("fixture"))


def result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_untraced_run(root):
    res = result(bench_fixture.run_cli(
        root, "--workload", bench_fixture.CELL, "--seed", "3000000019",
        "--seconds", "1.5", "--trace", "0"))
    assert res["correct"] is True
    assert res["attempted"] > 10 and res["failed"] == 0
    assert set(res["metrics"]) == {"ttft_p90_ms", "itl_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"]["widest_gap"]["value"] <= 1e-3
    kv = res["device"]["kv_pool"]
    assert 0 < kv["pages_peak"] <= kv["pages_reserved"]
    assert 0 < kv["bytes_peak"] <= kv["bytes_reserved"]


def test_traced_run_reports_the_added_metric(root):
    proc = bench_fixture.run_cli(
        root, "--workload", bench_fixture.CELL, "--seed", "11",
        "--seconds", "1.5", "--trace", "1")
    res = result(proc)
    assert res["correct"] is True
    # the cell reports the per-layer metrics that list it: the new one
    assert set(res["metrics"]) == {"fixture_ticks_per_request"}
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res
    assert proc.stderr.strip().splitlines()[-1] == "correct True"


def test_unknown_workload_is_refused(root):
    proc = bench_fixture.run_cli(root, "--workload", "nope", "--seed", "1",
                                 "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory with only `BENCHMARK.json` and `bench/` has no system
    to measure: the run fails and prints no result."""
    import os
    import shutil
    import subprocess
    import sys
    shutil.copytree(bench_fixture.REPO / "bench", tmp_path / "bench")
    shutil.copy(bench_fixture.REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for device in ("cuda", "cpu"):
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload",
             "granite-20b-widths-pim8.chat", "--seed", "1", "--seconds", "1",
             "--trace", "0", "--device", device],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0 and not proc.stdout.strip()
