"""CUDA kernel contract checker over `kernels/csrc/*.cu` and their
Python launchers: counterpart of `repro.analysis.kernel_contracts`.

The reference's KC101-KC106 check Pallas structure (BlockSpecs, scalar
prefetch, TPU DMA semaphores), which the CUDA kernels do not have. The
contracts that carry over are checked here under new ids, each standing
for the reference rule named beside it:

  KC201  (for KC102, operand arity) each launcher's `ctypes` argtypes
         list equals the parameters of the `extern "C"` entry it binds
         in count and in kind (pointer / int / float), and the launch
         passes that many arguments (the stream last). A mismatch shifts
         every argument, as a KC102 mismatch shifts every ref.
  KC202  (for KC103, a DMA never started or never awaited) in every
         `__global__` function, cp.async copies are committed, the
         committed groups are waited on, and the last commit is followed
         by a wait-group before the function ends.
  KC203  (for KC104, issue before fold) the first cp.async commit
         precedes the first wait-group.
  KC204  (for KC101, no whole operand mapped quietly) every tensor whose
         pointer reaches a launch is checked contiguous, on a CUDA device
         and of a supported dtype before it — by the launcher itself or
         by a checker it calls that tests all three — and the launcher
         copies no input (`.contiguous()`, `.to()`, ...): it refuses.
  KC205  each kernel module has its plain version in `kernels/ref.py`
         (the launcher calls `ref.<fn>`, defined there) and a `LAUNCHES`
         counter that the launcher increments.

The C++ side is read as text (comments and strings blanked, functions
found by brace matching). The cp.async events are the calls of
`tensor_core.cuh`'s `cp_async16`, `cp_async_commit` and
`cp_async_wait<N>`; a `__device__` helper defined in the file or in a
`csrc/*.cuh` it includes is expanded where it is called, so a commit in
a staging helper counts where the kernel calls it. `check_kernel_file`
takes one launcher (`.py`) or one source (`.cu`) — the fixture tests
use it; `check_kernel_contracts` applies it to the repo's kernels.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

#: the kernel package under contract, relative to the repo root
KERNEL_DIR = "src/repro_torch/kernels"

#: ctypes names by kind
_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer",
    "c_int": "int", "c_int32": "int", "c_int64": "int", "c_long": "int",
    "c_longlong": "int", "c_size_t": "int", "c_uint": "int",
    "c_uint32": "int", "c_uint64": "int", "c_bool": "int",
    "c_float": "float", "c_double": "float",
}
_C_INT = re.compile(r"\b(int|long|size_t|int32_t|int64_t|uint32_t|"
                    r"uint64_t|bool|unsigned)\b")
_C_FLOAT = re.compile(r"\b(float|double)\b")

#: methods that copy a tensor (a launcher must refuse, not copy)
_COPY_METHODS = frozenset({"contiguous", "to", "cuda", "clone", "float",
                           "half", "bfloat16", "type"})

_EVENTS = {"cp_async16": "copy", "cp_async_commit": "commit",
           "cp_async_wait": "wait"}


# ---------------------------------------------------------------------------
# C++ text
# ---------------------------------------------------------------------------

def _strip_comments(text: str, strings: bool = True) -> str:
    """Comments (and, with `strings`, string literals) blanked, newlines
    kept, so offsets still map to lines."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    pattern = r"//[^\n]*|/\*.*?\*/"
    if strings:
        pattern += r'|"(?:\\.|[^"\\])*"'
    return re.sub(pattern, blank, text, flags=re.S)


def _match_brace(text: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    return len(text) - 1


def _match_paren(text: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(text) - 1


_TOKEN = re.compile(r"[A-Za-z_]\w*|[(;{}]")


def _functions(text: str) -> Dict[str, Tuple[str, int, int]]:
    """name -> (qualifier, body start, body end) of every __global__ /
    __device__ function defined in `text` (declarations skipped). The
    name is the last identifier before the parameter list that does not
    start with `__` (`__launch_bounds__(...)` is skipped)."""
    out: Dict[str, Tuple[str, int, int]] = {}
    for m in re.finditer(r"\b(__global__|__device__)\b", text):
        i, name = m.end(), None
        while True:
            tok = _TOKEN.search(text, i)
            if tok is None or tok.group(0) in ";{}":
                break
            if tok.group(0) != "(":
                name, i = tok.group(0), tok.end()
                continue
            close = _match_paren(text, tok.start())
            if name is None or name.startswith("__"):
                name, i = None, close + 1
                continue
            end = re.compile(r"[{;]").search(text, close + 1)
            if end is not None and text[end.start()] == "{":
                out.setdefault(name, (m.group(1), end.start(),
                                      _match_brace(text, end.start())))
            break
    return out


def _line(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


class _Source:
    """One .cu file and the local headers it includes."""

    def __init__(self, path: str):
        self.path = path
        with open(path) as fh:
            self.text = _strip_comments(fh.read())
        self.funcs = _functions(self.text)
        self.helpers: Dict[str, Tuple[str, Tuple[str, int, int]]] = {}
        here = os.path.dirname(path)
        with open(path) as fh:
            raw = fh.read()
        for inc in re.findall(r'#include\s+"([^"]+)"', raw):
            hp = os.path.join(here, inc)
            if os.path.exists(hp):
                with open(hp) as fh:
                    htext = _strip_comments(fh.read())
                for name, span in _functions(htext).items():
                    if name not in _EVENTS:
                        self.helpers[name] = (htext, span)
        for name, span in self.funcs.items():
            self.helpers[name] = (self.text, span)

    def events(self, text: str, span, seen=()) -> List[Tuple[str, int]]:
        """(event, offset in `text`) in text order: cp.async copies,
        commits and waits, helpers expanded at their call."""
        _, lo, hi = span
        body = text[lo:hi]
        out: List[Tuple[str, int]] = []
        for m in re.finditer(r"\b([A-Za-z_]\w*)\s*(?:<[^<>;]*>)?\s*\(", body):
            name = m.group(1)
            if name in _EVENTS:
                out.append((_EVENTS[name], lo + m.start()))
            elif name in self.helpers and name not in seen:
                htext, hspan = self.helpers[name]
                sub = self.events(htext, hspan, seen + (name,))
                out.extend((e, lo + m.start()) for e, _ in sub)
        return sorted(out, key=lambda e: e[1])


def check_cuda_source(path: str, rel: Optional[str] = None
                      ) -> List[Finding]:
    """KC202 / KC203 over every `__global__` function of one source."""
    rel = rel or path
    src = _Source(path)
    findings: List[Finding] = []
    for name, span in sorted(src.funcs.items(), key=lambda f: f[1][1]):
        if span[0] != "__global__":
            continue
        ev = src.events(src.text, span)
        copies = [o for e, o in ev if e == "copy"]
        commits = [o for e, o in ev if e == "commit"]
        waits = [o for e, o in ev if e == "wait"]
        if copies and not commits:
            findings.append(Finding(
                "KC202", rel, _line(src.text, copies[0]), "error",
                f"`{name}` issues cp.async copies that are never committed "
                "(no `cp_async_commit`)"))
            continue
        if commits and not waits:
            findings.append(Finding(
                "KC202", rel, _line(src.text, commits[0]), "error",
                f"`{name}` commits cp.async groups that are never awaited "
                "(no `cp_async_wait`)"))
            continue
        if not commits:
            continue
        if max(commits) > max(waits):
            findings.append(Finding(
                "KC202", rel, _line(src.text, max(commits)), "error",
                f"`{name}`'s last cp.async commit (line "
                f"{_line(src.text, max(commits))}) has no wait-group after "
                "it — its shared buffer may be read before it lands"))
        if min(waits) < min(commits):
            findings.append(Finding(
                "KC203", rel, _line(src.text, min(waits)), "error",
                f"`{name}` waits on a cp.async group (line "
                f"{_line(src.text, min(waits))}) before its first commit "
                f"(line {_line(src.text, min(commits))}) — the "
                "issue-before-fold warm-up is inverted"))
    return findings


def _extern_params(cu_text: str, symbol: str) -> Optional[List[str]]:
    m = re.search(r'extern\s+"C"\s+\w[\w\s\*]*?\b' + re.escape(symbol)
                  + r"\s*\(([^)]*)\)", cu_text, flags=re.S)
    if not m:
        return None
    params = [p.strip() for p in m.group(1).split(",") if p.strip()]
    kinds = []
    for p in params:
        if "*" in p:
            kinds.append("pointer")
        elif _C_FLOAT.search(p):
            kinds.append("float")
        elif _C_INT.search(p):
            kinds.append("int")
        else:
            kinds.append("?")
    return kinds


# ---------------------------------------------------------------------------
# Python launchers
# ---------------------------------------------------------------------------

def _eval_argtypes(node: ast.AST) -> Optional[List[str]]:
    """The kinds of a `[ctypes.c_void_p] * 4 + [ctypes.c_int, ...]`
    expression, or None where it is not that shape."""
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for e in node.elts:
            name = e.attr if isinstance(e, ast.Attribute) else (
                e.id if isinstance(e, ast.Name) else None)
            if name not in _CTYPES_KIND:
                return None
            out.append(_CTYPES_KIND[name])
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _eval_argtypes(node.left), _eval_argtypes(node.right)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                inner = _eval_argtypes(seq)
                return None if inner is None else inner * n.value
    return None


def _module_assigns(tree: ast.Module) -> Dict[str, ast.AST]:
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and node.value is not None:
                    out[t.id] = node.value
    return out


def _names_in(node: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


def _is_checker(fn: ast.FunctionDef) -> bool:
    """A function that tests contiguity, the device and the dtype."""
    text = ast.unparse(fn)
    return ("is_contiguous" in text and "cuda" in text and "dtype" in text)


def _checkers(tree: ast.Module, kernel_dir: str) -> Dict[str, ast.FunctionDef]:
    """Functions of this module and of its sibling kernel modules that a
    launcher may call to check its operands."""
    out: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 1 \
                and node.module:
            path = os.path.join(kernel_dir, node.module + ".py")
            if os.path.exists(path):
                with open(path) as fh:
                    sib = ast.parse(fh.read())
                for f in sib.body:
                    if isinstance(f, ast.FunctionDef) and any(
                            a.name == f.name for a in node.names):
                        out[f.name] = f
    for f in tree.body:
        if isinstance(f, ast.FunctionDef):
            out[f.name] = f
    return {k: f for k, f in out.items() if _is_checker(f)}


def _launch_calls(fn: ast.FunctionDef):
    """The `launch_kernel(lib, symbol, argtypes, args, device)` calls of a
    launcher (`paged_common.launch_kernel`, the one way into a built
    library)."""
    if fn.name == "launch_kernel":
        return
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and ast.unparse(
                node.func).rsplit(".", 1)[-1] == "launch_kernel":
            yield node


def _ref_functions(kernel_dir: str) -> set:
    path = os.path.join(kernel_dir, "ref.py")
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        return {f.name for f in ast.parse(fh.read()).body
                if isinstance(f, ast.FunctionDef)}


def check_launcher(path: str, rel: Optional[str] = None,
                   csrc_dir: Optional[str] = None) -> List[Finding]:
    """KC201 / KC204 / KC205 over one Python launcher module."""
    rel = rel or path
    kernel_dir = os.path.dirname(path)
    csrc_dir = csrc_dir or os.path.join(kernel_dir, "csrc")
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    assigns = _module_assigns(tree)
    checkers = _checkers(tree, kernel_dir)
    ref_fns = _ref_functions(kernel_dir)
    findings: List[Finding] = []

    def err(rule, line, msg):
        findings.append(Finding(rule, rel, line, "error", msg))

    launchers = [f for f in tree.body if isinstance(f, ast.FunctionDef)
                 and any(True for _ in _launch_calls(f))]
    if launchers and "LAUNCHES" not in assigns:
        err("KC205", launchers[0].lineno,
            "kernel module has no module-level `LAUNCHES` counter")
    for fn in launchers:
        for call in _launch_calls(fn):
            _check_arity(call, assigns, csrc_dir, err)
            _check_operands(fn, call, checkers, err)
        if not any(isinstance(n, ast.AugAssign)
                   and isinstance(n.target, ast.Name)
                   and n.target.id == "LAUNCHES" for n in ast.walk(fn)):
            err("KC205", fn.lineno,
                f"launcher `{fn.name}` never increments `LAUNCHES`")
        refs = {n.attr for n in ast.walk(fn)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id == "ref"}
        if not refs & ref_fns:
            err("KC205", fn.lineno,
                f"launcher `{fn.name}` has no plain version: it calls no "
                "function of kernels/ref.py")
    return findings


def _check_arity(call: ast.Call, assigns, csrc_dir: str, err) -> None:
    args = call.args
    if len(args) < 3 or not all(isinstance(a, ast.Constant)
                                for a in args[:2]):
        return
    lib, symbol = args[0].value, args[1].value
    spec = args[2]
    if isinstance(spec, ast.Name) and spec.id in assigns:
        spec = assigns[spec.id]
    kinds = _eval_argtypes(spec)
    if kinds is None:
        err("KC201", call.lineno,
            f"`{symbol}`: argtypes are not a literal list of ctypes "
            "kinds the checker can read")
        return
    cu = os.path.join(csrc_dir, f"{lib}.cu")
    if not os.path.exists(cu):
        err("KC201", call.lineno, f"`{symbol}`: no source csrc/{lib}.cu")
        return
    with open(cu) as fh:
        # the `extern "C"` marker is a string literal: keep strings
        params = _extern_params(_strip_comments(fh.read(), strings=False),
                                symbol)
    if params is None:
        err("KC201", call.lineno,
            f"`{symbol}`: csrc/{lib}.cu has no `extern \"C\"` entry of "
            "that name")
        return
    if kinds != params:
        err("KC201", call.lineno,
            f"`{symbol}`: argtypes {len(kinds)} ({_kinds(kinds)}) but "
            f"csrc/{lib}.cu takes {len(params)} ({_kinds(params)}) — "
            "every argument after the first difference is shifted")
    if len(args) >= 4 and isinstance(args[3], ast.Tuple):
        passed = len(args[3].elts) + 1        # the stream, added last
        if passed != len(kinds):
            err("KC201", call.lineno,
                f"`{symbol}`: the launch passes {passed} arguments "
                f"(with the stream) but its argtypes declare {len(kinds)}")


def _kinds(kinds: Sequence[str]) -> str:
    out, prev, n = [], None, 0
    for k in list(kinds) + [None]:
        if k == prev:
            n += 1
            continue
        if prev is not None:
            out.append(f"{n} {prev}")
        prev, n = k, 1
    return ", ".join(out)


def _check_operands(fn: ast.FunctionDef, call: ast.Call, checkers, err
                    ) -> None:
    """KC204 for one launch inside launcher `fn`."""
    params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
    allocated = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and "empty" in ast.unparse(
                node.value) and "torch" in ast.unparse(node.value):
            allocated |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
    pointers = []
    for node in ast.walk(call):
        if isinstance(node, ast.Call) and ast.unparse(node.func) in (
                "ptr",) and node.args and isinstance(node.args[0], ast.Name):
            pointers.append(node.args[0].id)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "data_ptr" and isinstance(
                    node.func.value, ast.Name):
            pointers.append(node.func.value.id)
    before = [n for n in ast.walk(fn)
              if getattr(n, "lineno", 10 ** 9) < call.lineno]
    checked = set()
    own = {"contiguous": set(), "cuda": set(), "dtype": set()}
    for node in before:
        if isinstance(node, ast.Call):
            name = ast.unparse(node.func).rsplit(".", 1)[-1]
            if name in checkers:
                checked |= set(_names_in(node))
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "is_contiguous":
                own["contiguous"] |= set(_names_in(node.func.value))
        if isinstance(node, ast.Compare):
            text = ast.unparse(node)
            names = set(_names_in(node))
            if "cuda" in text and ".device" in text:
                own["cuda"] |= names
            if ".dtype" in text:
                own["dtype"] |= names
    checked |= own["contiguous"] & own["cuda"] & own["dtype"]
    for name in dict.fromkeys(pointers):
        if name in allocated:
            continue
        if name not in checked:
            err("KC204", call.lineno,
                f"`{fn.name}` passes `{name}`'s pointer to a launch without "
                "checking it contiguous, on a CUDA device and of a "
                "supported dtype first")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in _COPY_METHODS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params
                and node.lineno < call.lineno):
            err("KC204", node.lineno,
                f"`{fn.name}` copies its input `{node.func.value.id}` "
                f"(`.{node.func.attr}()`) before a launch — a launcher "
                "refuses an operand it cannot take, it never copies quietly")


# ---------------------------------------------------------------------------

def check_kernel_file(path: str, rel: Optional[str] = None
                      ) -> List[Finding]:
    """All kernel-contract findings for one `.cu` source or `.py`
    launcher."""
    if path.endswith(".cu"):
        return check_cuda_source(path, rel)
    return check_launcher(path, rel)


def check_kernel_contracts(root: str, kernel_dir: str = KERNEL_DIR
                           ) -> List[Finding]:
    """Kernel contracts over the repo's CUDA sources and launchers (a
    missing directory is skipped, so fixture repos can hold a subset)."""
    base = os.path.join(root, kernel_dir)
    if not os.path.isdir(base):
        return []
    findings: List[Finding] = []
    csrc = os.path.join(base, "csrc")
    if os.path.isdir(csrc):
        for nm in sorted(os.listdir(csrc)):
            if nm.endswith(".cu"):
                findings.extend(check_cuda_source(
                    os.path.join(csrc, nm), f"{kernel_dir}/csrc/{nm}"))
    for nm in sorted(os.listdir(base)):
        if nm.endswith(".py"):
            findings.extend(check_launcher(os.path.join(base, nm),
                                           f"{kernel_dir}/{nm}"))
    return findings
