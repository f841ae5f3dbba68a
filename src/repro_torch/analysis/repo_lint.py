"""Repo-convention lint over `src/repro_torch`: counterpart of
`repro.analysis.repo_lint` (DESIGN.md §15).

stdlib-`ast` rules for the conventions the serving stack depends on but
Python cannot enforce. The ids are the reference's; where a rule means
the same thing its findings carry the reference's messages word for
word, so one fixture tree gives both packages the same findings:

  RL201  a model step entry (`models.prefill_paged`,
         `decode_step_paged`, `prefill`, `decode_step`) called inside
         `serve/` anywhere but `serve/compiled.py`: the port runs
         eagerly, so its counterpart of the reference's "serve-step
         compiles only through `serve/compiled.py`" is that every step
         goes through a `ServeStep`, or it escapes `trace_count()`.
  RL202  kernel impl selection outside `kernels/ops.py`: comparing an
         `impl` variable against string literals forks the dispatch
         policy; `ops.resolve_impl` is the single arbiter. A guard on
         where a tensor lies (`q.device.type == "cpu"`,
         `dev.type == "cuda"`) is not impl dispatch and does not fire.
  RL203  unguarded telemetry access in scheduler/engine: the metrics-off
         contract (§13) is ZERO registry calls when `telemetry is None`,
         so every `tel.*` / `self.telemetry.*` use needs a None-guard in
         the same function (`if X is not None:`, `X is not None and ...`,
         `... if X is None else X.f()`, or an early `if X is None:
         return`).
  RL204  wall-clock reads (`time.time()` & friends, `datetime.now`) in
         `serve/` or `obs/` hot paths: serving time flows from the
         injected clock (`ManualClock` in tests). Allowlisted:
         `obs/metrics.py` and `obs/events.py` (where the injectable
         clock's *default* lives) and `obs/regress.py` (offline history
         stamps, not serving).
  RL205  every public `PagedKVCache`/`LayerPagePool` mutator must be
         exercised by at least one test file that also calls
         `check_invariants`.
  RL206  quantized-page dequantization outside `kernels/` (§16):
         `dequantize_pages` / `load_kv_page` referenced anywhere but
         `kernels/*`.

The import rule (no `jax`, nothing of `repro`) is not here: it lives in
`tests/test_torch_imports.py`, on the syntax tree of every port file.
The committed `analysis/baseline_torch.json` is empty.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding

#: the one serve module that may call the model's step entries
_JIT_HOME = "serve/compiled.py"
#: RL201: the model entries a serve step wraps
_STEP_ENTRIES = frozenset({"prefill_paged", "decode_step_paged", "prefill",
                           "decode_step"})
#: the single impl-dispatch arbiter
_IMPL_HOME = "kernels/ops.py"
#: RL203 scope: the engines whose metrics-off path must stay silent
_TELEMETRY_SCOPE = ("serve/scheduler.py", "serve/engine.py")
#: RL204 allowlist inside serve/ + obs/ (see module docstring)
_CLOCK_ALLOWED = ("obs/metrics.py", "obs/events.py", "obs/regress.py")
#: RL206: dequantization primitives that must stay inside kernels/ —
#: everything else appends through `requantize_page_update` (§16)
_DEQUANT_NAMES = frozenset({"dequantize_pages", "load_kv_page"})

_WALL_CLOCK_CALLS = frozenset({
    "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "time.time_ns", "time.monotonic_ns",
    "time.perf_counter_ns", "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})

_MUTATING_CALLS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "discard", "add", "clear", "update", "setdefault",
    "sort", "reverse",
})


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    par: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _rooted_at_self(node: ast.AST) -> bool:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _imported_step_entries(tree: ast.Module) -> Set[str]:
    """Local names bound to a model step entry by `from ..models import
    ...` (any module path through `models`)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and "models" in (
                node.module or "").split("."):
            out |= {a.asname or a.name for a in node.names
                    if a.name in _STEP_ENTRIES}
    return out


def _step_entry(func: ast.AST, step_names: Set[str]) -> bool:
    """A call target that is a model step entry: a name imported from
    `models`, or `models.X` / `transformer.X`."""
    if isinstance(func, ast.Name):
        return func.id in step_names
    return (isinstance(func, ast.Attribute) and func.attr in _STEP_ENTRIES
            and _unparse(func.value).rsplit(".", 1)[-1]
            in ("models", "transformer"))


# ---------------------------------------------------------------------------
# per-module rules (RL201/RL202/RL204/RL206)
# ---------------------------------------------------------------------------

def _check_module(tree: ast.Module, rel: str, disp: str
                  ) -> List[Finding]:
    findings: List[Finding] = []
    in_serve = rel.startswith("serve/")
    impl_scope = rel != _IMPL_HOME
    clock_scope = (
        rel.startswith(("serve/", "obs/")) and rel not in _CLOCK_ALLOWED
    )
    dequant_scope = not rel.startswith("kernels/")
    step_names = _imported_step_entries(tree) if in_serve else set()

    for node in ast.walk(tree):
        if dequant_scope and (
            (isinstance(node, ast.Name) and node.id in _DEQUANT_NAMES)
            or (isinstance(node, ast.Attribute)
                and node.attr in _DEQUANT_NAMES)
            or (isinstance(node, ast.ImportFrom) and any(
                a.name in _DEQUANT_NAMES for a in node.names))
        ):
            ref = (
                node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute)
                else next(a.name for a in node.names
                          if a.name in _DEQUANT_NAMES)
            )
            findings.append(Finding(
                "RL206", disp, node.lineno, "error",
                f"`{ref}` referenced outside kernels/ — dequantization "
                "happens only inside the paged page-fold (§16); append "
                "through the opaque `requantize_page_update` instead",
            ))
        if (
            in_serve and rel != _JIT_HOME
            and isinstance(node, ast.Call)
            and _step_entry(node.func, step_names)
        ):
            findings.append(Finding(
                "RL201", disp, node.lineno, "error",
                f"`{_unparse(node.func)}` called in serve/ outside "
                "serve/compiled.py — serve steps must run through the "
                "`ServeStep` factories (paged_*_step/dense_*_step) so "
                "every step signature is counted by `trace_count()`",
            ))
        if isinstance(node, ast.Call):
            name = _unparse(node.func)
            if clock_scope and name in _WALL_CLOCK_CALLS:
                findings.append(Finding(
                    "RL204", disp, node.lineno, "error",
                    f"wall-clock call `{name}()` in a serve/obs hot "
                    "path — time must flow from the injected registry "
                    "clock (ManualClock in tests)",
                ))
        if impl_scope and isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            impl_vars = [
                s for s in sides
                if isinstance(s, (ast.Name, ast.Attribute))
                and (
                    (tail := _unparse(s).rsplit(".", 1)[-1]) == "impl"
                    or tail.endswith("_impl")
                )
            ]
            literal = any(
                isinstance(s, ast.Constant) and isinstance(s.value, str)
                for s in sides
            ) or any(
                isinstance(s, (ast.Tuple, ast.List, ast.Set))
                and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in s.elts
                )
                for s in sides
            )
            if impl_vars and literal:
                findings.append(Finding(
                    "RL202", disp, node.lineno, "error",
                    f"impl string compared outside kernels/ops.py "
                    f"(`{_unparse(node)}`) — route kernel selection "
                    "through `ops.resolve_impl`",
                ))
    return findings


# ---------------------------------------------------------------------------
# RL203: telemetry guard analysis
# ---------------------------------------------------------------------------

def _is_null_test(test: ast.AST, telem: Set[str]) -> Optional[bool]:
    """True = test asserts the telemetry expr IS None, False = IS NOT
    None, None = unrelated test."""
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
        and _unparse(test.left) in telem
    ):
        if isinstance(test.ops[0], ast.Is):
            return True
        if isinstance(test.ops[0], ast.IsNot):
            return False
    # truthiness: `tel and tel.f()`
    if isinstance(test, (ast.Name, ast.Attribute)) and _unparse(test) in telem:
        return False
    return None


def _guarded(node: ast.AST, fn: ast.FunctionDef, telem: Set[str],
             parents: Dict[ast.AST, ast.AST]) -> bool:
    # (a) enclosing If / IfExp / and-chain with a None-check
    child, anc = node, parents.get(node)
    while anc is not None and anc is not fn:
        if isinstance(anc, (ast.If, ast.IfExp)):
            isnull = _is_null_test(anc.test, telem)
            if isnull is not None:
                body = anc.body if isinstance(anc.body, list) else [anc.body]
                orelse = (
                    anc.orelse if isinstance(anc.orelse, list)
                    else [anc.orelse]
                )
                in_body = any(
                    child is b or child in ast.walk(b) for b in body
                )
                in_orelse = any(
                    child is b or child in ast.walk(b) for b in orelse
                )
                if (not isnull and in_body) or (isnull and in_orelse):
                    return True
        if isinstance(anc, ast.BoolOp) and isinstance(anc.op, ast.And):
            for i, v in enumerate(anc.values):
                if child is v or child in ast.walk(v):
                    if any(
                        _is_null_test(anc.values[j], telem) is False
                        for j in range(i)
                    ):
                        return True
                    break
        child, anc = anc, parents.get(anc)
    # (b) early `if X is None: return/raise/continue` before the access
    for stmt in fn.body:
        if getattr(stmt, "lineno", 10**9) >= node.lineno:
            break
        if (
            isinstance(stmt, ast.If)
            and _is_null_test(stmt.test, telem) is True
            and stmt.body
            and all(
                isinstance(s, (ast.Return, ast.Raise, ast.Continue))
                for s in stmt.body
            )
        ):
            return True
    return False


def _check_telemetry_guards(tree: ast.Module, disp: str) -> List[Finding]:
    findings: List[Finding] = []
    parents = _parents(tree)
    funcs = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in funcs:
        telem: Set[str] = {"self.telemetry"}
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            if a.arg in ("telemetry", "tel"):
                telem.add(a.arg)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and _unparse(node.value) in telem
                ):
                    telem.add(t.id)
        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and _unparse(node.value) in telem
            ):
                continue
            # the alias assignment itself (`tel = self.telemetry`) and
            # `self.telemetry` appearing inside a None-test are reads of
            # the handle, not registry calls
            par = parents.get(node)
            if isinstance(par, (ast.Compare,)) or (
                isinstance(par, ast.Assign) and node in par.targets
            ):
                continue
            if _unparse(node) in telem:
                continue
            if not _guarded(node, fn, telem, parents):
                findings.append(Finding(
                    "RL203", disp, node.lineno, "error",
                    f"`{_unparse(node)}` used without a telemetry "
                    "None-guard in `" + fn.name + "` — the metrics-off "
                    "path must make zero registry calls (§13)",
                ))
    return findings


# ---------------------------------------------------------------------------
# RL205: mutator test coverage
# ---------------------------------------------------------------------------

_CACHE_CLASSES = ("PagedKVCache", "LayerPagePool")


def _direct_mutator(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            flat = []
            for t in targets:
                flat.extend(
                    t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                )
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                and _rooted_at_self(t)
                for t in flat
            ):
                return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATING_CALLS
            and _rooted_at_self(node.func.value)
        ):
            return True
    return False


def _class_methods(tree: ast.Module, names: Tuple[str, ...]
                   ) -> Dict[str, List[ast.FunctionDef]]:
    out: Dict[str, List[ast.FunctionDef]] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in names:
            out[node.name] = [
                n for n in node.body if isinstance(n, ast.FunctionDef)
            ]
    return out


def _check_mutator_coverage(root: str, src_rel: str, tests_rel: str
                            ) -> List[Finding]:
    path = os.path.join(root, src_rel, "serve", "paged_cache.py")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    classes = _class_methods(tree, _CACHE_CLASSES)

    mutators: Set[str] = set()
    for methods in classes.values():
        for m in methods:
            if m.name != "__init__" and _direct_mutator(m):
                mutators.add(m.name)
    # transitive closure: a method that calls a known mutator (on self,
    # a pool, or any receiver) is itself a mutator
    changed = True
    while changed:
        changed = False
        for methods in classes.values():
            for m in methods:
                if m.name in mutators or m.name == "__init__":
                    continue
                calls = {
                    n.func.attr for n in ast.walk(m)
                    if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                }
                if calls & mutators:
                    mutators.add(m.name)
                    changed = True

    # evidence: per test file, the set of attribute-call names plus
    # whether it also asserts invariants
    covered: Set[str] = set()
    tests_dir = os.path.join(root, tests_rel)
    if os.path.isdir(tests_dir):
        for nm in sorted(os.listdir(tests_dir)):
            if not nm.endswith(".py"):
                continue
            with open(os.path.join(tests_dir, nm)) as fh:
                try:
                    ttree = ast.parse(fh.read(), filename=nm)
                except SyntaxError:
                    continue
            calls = {
                n.func.attr for n in ast.walk(ttree)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
            }
            if "check_invariants" in calls:
                covered |= calls

    findings: List[Finding] = []
    disp = f"{src_rel}/serve/paged_cache.py"
    for cls, methods in sorted(classes.items()):
        for m in methods:
            if (
                m.name in mutators
                and not m.name.startswith("_")
                and not any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in m.decorator_list
                )
                and m.name not in covered
            ):
                findings.append(Finding(
                    "RL205", disp, m.lineno, "error",
                    f"public mutator `{cls}.{m.name}` has no call site "
                    "in any test that also runs `check_invariants` — "
                    "page-accounting corruption would go unnoticed",
                ))
    return findings


# ---------------------------------------------------------------------------

def check_repo_conventions(
    root: str, src_rel: str = "src/repro_torch", tests_rel: str = "tests"
) -> List[Finding]:
    """All RL2xx findings for the repo rooted at `root`."""
    findings: List[Finding] = []
    src_dir = os.path.join(root, src_rel)
    for dirpath, dirnames, names in os.walk(src_dir):
        dirnames.sort()
        for nm in sorted(names):
            if not nm.endswith(".py"):
                continue
            path = os.path.join(dirpath, nm)
            rel = os.path.relpath(path, src_dir).replace(os.sep, "/")
            disp = f"{src_rel}/{rel}"
            with open(path) as fh:
                try:
                    tree = ast.parse(fh.read(), filename=path)
                except SyntaxError as e:
                    findings.append(Finding(
                        "RL200", disp, e.lineno or 0, "error",
                        f"unparseable module: {e.msg}",
                    ))
                    continue
            findings.extend(_check_module(tree, rel, disp))
            if rel in _TELEMETRY_SCOPE:
                findings.extend(_check_telemetry_guards(tree, disp))
    findings.extend(_check_mutator_coverage(root, src_rel, tests_rel))
    return findings
