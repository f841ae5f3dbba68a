"""The control comes out not correct: the plain reference put in the
program's place at the precision below the configuration's. On the CPU at
a size a test run holds (a bf16 smoke model, whose control is fp8); on
the card (`-m gpu`) at each cell's own size and load."""

import time

import pytest
import torch

from bench import run as bench_run
from bench.tests import bench_fixture


def readings(root, cell, seeds, device, seconds):
    out = []
    for seed in seeds:
        res = bench_run.run(root, cell, seed, seconds, False, device,
                            time.perf_counter(), control=True)
        out.append((res["program"]["widest_gap"],
                    res["control"]["widest_gap"]))
    return out


def test_control_separates_at_smoke_size(tmp_path):
    model = dict(bench_fixture.TINY, dtype="bfloat16")
    root = bench_fixture.make(tmp_path, model=model, limit=0.01)
    cell = bench_run.load_cell(root, bench_fixture.CELL)
    got = readings(root, cell, (31, 32, 33), torch.device("cpu"), 1.0)
    program = max(p for p, _ in got)
    control = min(c for _, c in got)
    assert control >= 3 * program, got
    assert control > 0.01 >= program, got


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["granite-20b-widths-pim8.chat"])
def test_control_fails_the_cell_limit_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = bench_fixture.REPO
    cell = bench_run.load_cell(root, workload)
    limit = cell["limits"]["widest_gap"]["limit"]
    for program, control in readings(root, cell, (41,),
                                     torch.device("cuda"), 10.0):
        assert program <= limit < control
