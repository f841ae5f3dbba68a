"""No module a run loads has the top-level name `jax` or `repro` (compared
whole: `repro_torch` is the port), and the plain reference and the
yardstick load nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from bench.tests import bench_fixture

BENCH = Path(__file__).resolve().parents[1]
#: the modules that may import the program: the system under test and the
#: entry points that build it
PROGRAM_SIDE = {"system.py", "run.py", "control.py"}


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_only_the_system_imports_the_port():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        roots = set(imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "repro"}, path
        if path.name not in PROGRAM_SIDE:
            assert "repro_torch" not in roots, path


def test_reference_and_yardstick_load_nothing_of_the_program():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from bench import check, reduce, traffic, work, loop, trace\n"
        "from bench.system import load_family\n"
        "load_family('dense_decoder')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    ) % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    roots = set(json.loads(out))
    assert not roots & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_exits_when_the_jax_package_is_loaded(tmp_path):
    root = bench_fixture.make(tmp_path)
    # a program that pulls in a module named `repro` during the run
    (tmp_path / "shim").mkdir()
    (tmp_path / "shim" / "repro.py").write_text("")
    (tmp_path / "shim" / "sitecustomize.py").write_text("")
    run = root / "bench" / "run.py"
    src = run.read_text().replace(
        "    import torch\n    torch.set_num_threads(1)",
        "    import torch\n    torch.set_num_threads(1)\n    import repro")
    assert src != run.read_text()
    run.write_text(src)
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(bench_fixture.REPO / "src"), str(tmp_path / "shim")])
    proc = subprocess.run(
        [sys.executable, str(run), "--workload", bench_fixture.CELL,
         "--seed", "4", "--seconds", "0.5", "--trace", "0",
         "--device", "cpu"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 4, proc.stderr[-2000:]
    assert not proc.stdout.strip()
    assert "repro" in proc.stderr
