"""`repro_torch.analysis` on the CPU: each seeded violation is caught by
exactly its rule id and each clean idiom passes; RL202-RL206 give the
reference's findings on one fixture tree laid out under both package
names; the real tree passes every layer; the gate exits 1 on a new
finding and 0 once it is baselined; the findings JSON is the
reference's schema.

Fixture layout mirrors the reference's tests/test_analysis.py: dispatch
rules get tiny callables, kernel-contract rules get fixture launchers and
CUDA sources, repo rules get a miniature `src/repro_torch` tree."""

import json
import os
import textwrap

import pytest
import torch

from repro.analysis.findings import Finding as JFinding
from repro.analysis.findings import diff_findings as j_diff_findings
from repro.analysis.findings import write_findings_json as j_write_findings
from repro.analysis.repo_lint import check_repo_conventions as j_repo_lint
from repro_torch.analysis import run_all
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.dispatch_lint import lint_call, lint_serve_steps
from repro_torch.analysis.findings import (
    Finding,
    diff_findings,
    load_baseline,
    write_findings_json,
)
from repro_torch.analysis.kernel_contracts import (
    check_kernel_contracts,
    check_kernel_file,
)
from repro_torch.analysis.repo_lint import check_repo_conventions
from repro_torch.kernels import work
from repro_torch.models import attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# layer 1: the dispatch lint on tiny callables
# ---------------------------------------------------------------------------

def test_jx001_host_round_trip():
    x = torch.ones(4)
    found = lint_call(lambda: float(x.sum().item()), "<fixture>")
    assert rules(found) == {"JX001"}
    assert "_local_scalar_dense" in found[0].message
    assert rules(lint_call(lambda: bool(x.any()), "<fixture>")) == {"JX001"}
    assert lint_call(lambda: x.sum() * 2, "<fixture>") == []


def test_jx002_float64_creep():
    x = torch.ones(4)
    found = lint_call(lambda: x.double() * 2, "<fixture>")
    assert rules(found) == {"JX002"}
    assert all(f.severity == "error" for f in found)
    assert rules(lint_call(lambda: x * 2, "<fixture>",
                           inputs=[x.double()])) == {"JX002"}


def test_jx003_whole_pool_and_layer_pool_copies():
    pool = torch.zeros((2, 8, 4, 1, 4))            # [L, n_blocks, bs, KV, hd]
    found = lint_call(lambda: pool * 2.0, "<fixture>", pools=[pool],
                      n_layers=2)
    assert rules(found) == {"JX003"}
    assert "whole-pool" in found[0].message
    # a layer's pages copied out of the pool (a .contiguous() before a
    # launch) is a layer-pool copy
    found = lint_call(lambda: pool[0].transpose(0, 1).contiguous(),
                      "<fixture>", pools=[pool], n_layers=2)
    assert rules(found) == {"JX003"}
    assert "layer-pool" in found[0].message


def test_jx003_exempts_views_page_writes_and_kernels():
    pool = torch.zeros((2, 8, 4, 1, 4))

    def writes():
        pool[:, 3] = 1.0                     # in place
        return pool.view(2, -1)[:, :5]       # a view

    assert lint_call(writes, "<fixture>", pools=[pool], n_layers=2) == []

    def kernel():
        with work.dispatch("paged_decode", lambda: (0.0, 0.0)):
            return pool * 2.0                # the plain route's own work

    assert lint_call(kernel, "<fixture>", pools=[pool], n_layers=2) == []


def test_jx004_selected_plans_vs_layer_groups():
    plan = ((1, 1),)
    perms = (torch.zeros(1, dtype=torch.int64),) * 3

    def layers(n_plans, classes):
        def fn():
            for c in classes:
                attention._select_bucket_plan(
                    lambda p, q: None, (plan,) * n_plans, perms[:n_plans], c)
        return fn

    found = lint_call(layers(3, [0, 1, 2]), "<fixture>", expected_groups=2)
    assert rules(found) == {"JX004"}
    assert lint_call(layers(2, [0, 1, 1, 0]), "<fixture>",
                     expected_groups=2) == []
    # a plan tuple of the right size whose layers all pick one plan
    assert rules(lint_call(layers(2, [0, 0]), "<fixture>",
                           expected_groups=2)) == {"JX004"}


def test_jx005_integer_input_off_the_declared_dtype():
    tok = torch.tensor([[1], [2]])                 # a default int64
    found = lint_call(lambda: tok + 1, "<fixture>", int_inputs=[tok])
    assert rules(found) == {"JX005"}
    assert found[0].severity == "warning"
    ok = tok.to(torch.int32)
    assert lint_call(lambda: ok + 1, "<fixture>", int_inputs=[ok]) == []
    perm = torch.zeros(2, dtype=torch.int32)
    assert rules(lint_call(lambda: None, "<fixture>",
                           perm_inputs=[perm])) == {"JX005"}


def test_real_serve_steps_lint_clean_on_the_cpu():
    assert lint_serve_steps(device="cpu") == []


# ---------------------------------------------------------------------------
# layer 2: kernel contracts on fixture launchers and sources
# ---------------------------------------------------------------------------

LAUNCHER = """
    import ctypes

    import torch

    from . import ref
    from .paged_common import launch_kernel, ptr

    LAUNCHES = 0

    _ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


    def scale_rows(x):
        global LAUNCHES
        if x.device.type == "cpu":
            return ref.scale_rows_ref(x)
        if (x.device.type != "cuda" or not x.is_contiguous()
                or x.dtype != torch.float32):
            raise ValueError("scale_rows: a contiguous f32 CUDA tensor")
        out = torch.empty_like(x)
        launch_kernel("scale", "scale_launch", _ARGTYPES, (
            ptr(x), ptr(out), x.shape[0], x.shape[1],
        ), x.device)
        LAUNCHES += 1
        return out
    """

SOURCE = """
    #include "tensor_core.cuh"

    __device__ void stage(float* s, const float* g) {
      tc::cp_async16(s, g, 16);
      tc::cp_async_commit();
    }

    __global__ void __launch_bounds__(128) scale_kernel(const float* x,
                                                        float* out) {
      __shared__ float s[256];
      stage(s, x);
      for (int i = 0; i < 4; ++i) {
        stage(s, x + i);
        tc::cp_async_wait<1>();
        __syncthreads();
        out[i] = s[i];
      }
      tc::cp_async_wait<0>();
    }

    extern "C" int scale_launch(const void* x, void* out, int rows,
                                int cols, void* stream) {
      return 0;
    }
    """


def _kernels(tmp_path, launcher=LAUNCHER, source=SOURCE):
    d = tmp_path / "src" / "repro_torch" / "kernels"
    (d / "csrc").mkdir(parents=True, exist_ok=True)
    (d / "launcher.py").write_text(textwrap.dedent(launcher))
    (d / "ref.py").write_text("def scale_rows_ref(x):\n    return x\n")
    (d / "csrc" / "scale.cu").write_text(textwrap.dedent(source))
    (d / "csrc" / "tensor_core.cuh").write_text(
        "__device__ __forceinline__ void cp_async_commit() {}\n")
    return d


def test_fixture_kernel_is_in_contract(tmp_path):
    _kernels(tmp_path)
    assert check_kernel_contracts(str(tmp_path)) == []


def test_kc201_argtypes_against_extern_c(tmp_path):
    d = _kernels(tmp_path, LAUNCHER.replace("[ctypes.c_int] * 2",
                                            "[ctypes.c_int] * 3"))
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC201"}
    assert any("csrc/scale.cu takes 5" in f.message for f in found)
    d = _kernels(tmp_path, LAUNCHER.replace("[ctypes.c_int] * 2",
                                            "[ctypes.c_float] * 2"))
    assert rules(check_kernel_file(str(d / "launcher.py"))) == {"KC201"}
    d = _kernels(tmp_path, LAUNCHER.replace("x.shape[0], x.shape[1],",
                                            "x.shape[0],"))
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC201"}
    assert "passes 4 arguments" in found[0].message


def test_kc202_kc203_cp_async_order(tmp_path):
    no_wait = SOURCE.replace("tc::cp_async_wait<1>();", "").replace(
        "tc::cp_async_wait<0>();", "")
    d = _kernels(tmp_path, source=no_wait)
    found = check_kernel_file(str(d / "csrc" / "scale.cu"))
    assert rules(found) == {"KC202"} and "never awaited" in found[0].message
    no_commit = SOURCE.replace("tc::cp_async_commit();", "")
    d = _kernels(tmp_path, source=no_commit)
    found = check_kernel_file(str(d / "csrc" / "scale.cu"))
    assert rules(found) == {"KC202"} and "never committed" in found[0].message
    last_unwaited = SOURCE.replace("tc::cp_async_wait<0>();",
                                   "stage(s, x);")
    d = _kernels(tmp_path, source=last_unwaited)
    found = check_kernel_file(str(d / "csrc" / "scale.cu"))
    assert rules(found) == {"KC202"} and "no wait-group" in found[0].message
    inverted = SOURCE.replace("      stage(s, x);\n      for",
                              "      tc::cp_async_wait<0>();\n      for")
    d = _kernels(tmp_path, source=inverted)
    assert rules(check_kernel_file(str(d / "csrc" / "scale.cu"))) == {
        "KC203"}


def test_kc204_operands_checked_never_copied(tmp_path):
    unchecked = LAUNCHER.replace(
        '''        if (x.device.type != "cuda" or not x.is_contiguous()
                or x.dtype != torch.float32):
            raise ValueError("scale_rows: a contiguous f32 CUDA tensor")
''', "")
    d = _kernels(tmp_path, unchecked)
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC204"} and "`x`" in found[0].message
    copies = LAUNCHER.replace("        out = torch.empty_like(x)\n",
                              "        x = x.contiguous()\n"
                              "        out = torch.empty_like(x)\n")
    d = _kernels(tmp_path, copies)
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC204"} and "never copies" in found[0].message


def test_kc205_plain_version_and_counter(tmp_path):
    d = _kernels(tmp_path, LAUNCHER.replace("        LAUNCHES += 1\n", ""))
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC205"} and "LAUNCHES" in found[0].message
    d = _kernels(tmp_path, LAUNCHER.replace(
        "            return ref.scale_rows_ref(x)",
        "            return x * 2"))
    found = check_kernel_file(str(d / "launcher.py"))
    assert rules(found) == {"KC205"} and "plain version" in found[0].message


def test_real_kernels_pass_contracts():
    assert check_kernel_contracts(ROOT) == []


# ---------------------------------------------------------------------------
# layer 3: repo conventions on a miniature tree
# ---------------------------------------------------------------------------

def _mini_repo(tmp_path, files, package="repro_torch"):
    for rel, src in files.items():
        p = tmp_path / "src" / package / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    (tmp_path / "tests").mkdir(exist_ok=True)
    return str(tmp_path)


def test_rl201_model_step_outside_compiled(tmp_path):
    root = _mini_repo(tmp_path, {
        "serve/engine.py": """
            from ..models import decode_step_paged
            from .. import models

            def step(p, t):
                models.prefill(p, t)
                return decode_step_paged(p, t)
            """,
        "serve/compiled.py": """
            from ..models import decode_step_paged

            def fn(p, t):
                return decode_step_paged(p, t)
            """,
    })
    found = check_repo_conventions(root)
    assert rules(found) == {"RL201"}
    assert {f.file for f in found} == {"src/repro_torch/serve/engine.py"}
    assert len(found) == 2


def test_rl202_device_guards_are_not_impl_dispatch(tmp_path):
    root = _mini_repo(tmp_path, {
        "kernels/foo.py": """
            def launch(q, impl):
                if q.device.type == "cpu":
                    return 0
                if q.dtype == "float32":
                    return 1
                return 2
            """,
        "kernels/ops.py": """
            def resolve_impl(impl, device):
                if impl in ("ref", "auto"):
                    return "ref"
                return "cuda"
            """,
    })
    assert check_repo_conventions(root) == []


PARITY_TREE = {
    "kernels/foo.py": """
        def pick(impl, kernel_impl):
            if impl == "cuda":
                return 1
            if kernel_impl in ("ref", "auto"):
                return 2
            return 0
        """,
    "serve/engine.py": """
        import time

        class Engine:
            def __init__(self, telemetry):
                self.telemetry = telemetry

            def step(self):
                self.telemetry.on_decode([1])
                return time.perf_counter()

            def tick(self):
                if self.telemetry is not None:
                    self.telemetry.end_tick(0, 0)
        """,
    "serve/cache.py": """
        from repro.kernels.paged_common import dequantize_pages

        def peek(codes, scales):
            return dequantize_pages(codes, scales)
        """,
    "serve/paged_cache.py": """
        class LayerPagePool:
            def grow(self, slot, n):
                self._owned[slot] = n

            def shrink(self, slot):
                self._owned.pop(slot)

            def check_invariants(self, lengths, external):
                pass
        """,
    "obs/metrics.py": """
        import time

        def default_clock():
            return time.perf_counter()
        """,
    "kernels/paged_common.py": """
        def dequantize_pages(codes, scales):
            return codes * scales

        def requantize_page_update(codes, scales, update_fn):
            return update_fn(dequantize_pages(codes, scales))
        """,
}


def test_rl202_to_rl206_equal_the_reference(tmp_path):
    """One tree under both package names: the same (rule, file within
    the package, message) findings for every rule whose meaning carries
    over."""
    for package in ("repro", "repro_torch"):
        _mini_repo(tmp_path, PARITY_TREE, package)
    (tmp_path / "tests" / "test_pool.py").write_text(textwrap.dedent("""
        def test_grow():
            pool.grow(0, 4)
            pool.check_invariants([4], None)
        """))

    def keyed(findings, package):
        return sorted((f.rule, f.file.split(f"src/{package}/", 1)[1],
                       f.message) for f in findings)

    want = keyed(j_repo_lint(str(tmp_path)), "repro")
    got = keyed(check_repo_conventions(str(tmp_path)), "repro_torch")
    assert got == want
    assert {r for r, _, _ in got} == {"RL202", "RL203", "RL204", "RL205",
                                      "RL206"}
    # the clean idioms: a guarded telemetry read, the clock's default in
    # obs/metrics.py, dequantization inside kernels/, a covered mutator
    files = {f for _, f, _ in got}
    assert "obs/metrics.py" not in files
    assert "kernels/paged_common.py" not in files
    assert not any("grow" in m or "end_tick" in m for _, _, m in got)


def test_clean_repo_all_layers():
    assert run_all(ROOT, layers=("repo", "kernels", "dispatch"),
                   device="cpu") == []


# ---------------------------------------------------------------------------
# the gate and the findings JSON
# ---------------------------------------------------------------------------

def test_gate_passes_on_the_tree(tmp_path):
    out = tmp_path / "findings.json"
    assert main(["--gate", "--device", "cpu", "--json", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["counts"]["total"] == 0 and blob["counts"]["new"] == 0
    assert blob["baseline"].endswith("analysis/baseline_torch.json")


def test_gate_fails_on_a_seeded_finding_until_baselined(tmp_path):
    root = _mini_repo(tmp_path, {"serve/engine.py": """
        import time

        def now():
            return time.time()
        """})
    out, base = tmp_path / "f.json", tmp_path / "baseline.json"
    argv = ["--root", root, "--layers", "repo,kernels", "--gate",
            "--json", str(out), "--baseline", str(base)]
    assert main(argv) == 1
    found = json.loads(out.read_text())["new"]
    assert [f["rule"] for f in found] == ["RL204"]
    base.write_text(json.dumps({"schema": 1, "findings": found}))
    assert main(argv) == 0
    assert load_baseline(str(base)) == [
        (f["rule"], f["file"], f["message"]) for f in found]


def test_findings_json_is_the_reference_schema(tmp_path):
    rows = [("RL204", "src/x.py", 3, "error", "m1"),
            ("JX005", "<dispatch:decode>", 0, "warning", "m2")]
    base = [("RL204", "src/x.py", "m1"), ("KC201", "k.py", "gone")]
    blobs = []
    for cls, diff, write in ((Finding, diff_findings, write_findings_json),
                             (JFinding, j_diff_findings, j_write_findings)):
        fs = [cls(*r) for r in rows]
        new, stale = diff(fs, base)
        path = tmp_path / f"{cls.__module__}.json"
        blobs.append(write(str(path), fs, new, stale, "b.json"))
        assert json.loads(path.read_text()) == blobs[-1]
    assert blobs[0] == blobs[1]
    assert blobs[0]["counts"]["new"] == 1
    assert blobs[0]["counts"]["stale_baseline"] == 1


def test_committed_baseline_is_empty():
    path = os.path.join(ROOT, "analysis", "baseline_torch.json")
    with open(path) as fh:
        assert json.load(fh)["schema"] == 1
    assert load_baseline(path) == []


@pytest.mark.parametrize("layer", ["repo", "kernels", "dispatch"])
def test_each_layer_clean_alone(layer):
    assert run_all(ROOT, layers=(layer,), device="cpu") == []
