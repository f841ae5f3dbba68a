"""The PyTorch port stands alone: no module of `src/repro_torch/`, and
neither `chip_smoke.py`, `chip_ab.py` nor the port's examples
(`examples/*_torch.py`), imports `jax`, the JAX
package `repro` (importing `repro` imports JAX) or the reference's
`benchmarks`. Checked on the syntax tree, so a lazy import inside a
function counts too."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_ab.py",
    REPO / "examples" / "train_lm_torch.py",
    REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "serve_pim_gemv_torch.py",
]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and not node.args[0].value.startswith(".")):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_checker_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.kernels import ops\n"
           "def f():\n    import importlib\n"
           "    importlib.import_module('repro.serve')\n"
           "from repro_torch import kernels\nfrom . import ref\n"
           "from benchmarks.paper_tables import table9_curvefit\n")
    roots = [r for _, r in _imported_roots(ast.parse(src))]
    assert sorted(r for r in roots if r in FORBIDDEN) == [
        "benchmarks", "jax", "repro", "repro"]
