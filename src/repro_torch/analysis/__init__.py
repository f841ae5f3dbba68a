"""Static analysis of the port: counterpart of `repro.analysis`.

Three layers (DESIGN.md §15), each producing `Finding` records with a
rule id, file:line, severity and message:

  * `dispatch_lint`    — run the real serve steps of `serve/compiled.py`
    under a `TorchDispatchMode` and walk the aten ops they dispatch for
    host round-trips, float64 creep, whole-pool copies, per-layer plan
    selections that disagree with `models.layer_attn_groups`, and
    integer inputs off the declared dtype (JX001-JX005; the reference's
    `jaxpr_lint`).
  * `kernel_contracts` — the CUDA kernels and their `ctypes` launchers:
    argument arity and kinds against the `extern "C"` entries, cp.async
    commit / wait ordering, operand checks before a launch, a plain
    version and a launch counter per kernel (KC201-KC205).
  * `repo_lint`        — stdlib-`ast` conventions over `src/repro_torch`
    (RL201-RL206, the reference's ids).

The committed `analysis/baseline_torch.json` makes the gate
(`python -m repro_torch.analysis --gate`) fail only on NEW findings; it
is empty, and a finding in the port is fixed, not baselined.
"""

from .findings import (
    Finding,
    diff_findings,
    load_baseline,
    write_findings_json,
)
from .dispatch_lint import lint_call, lint_serve_steps, probe_config
from .kernel_contracts import check_kernel_contracts
from .repo_lint import check_repo_conventions

__all__ = [
    "Finding",
    "check_kernel_contracts",
    "check_repo_conventions",
    "diff_findings",
    "lint_call",
    "lint_serve_steps",
    "load_baseline",
    "probe_config",
    "run_all",
    "write_findings_json",
]


def run_all(root: str, layers=("dispatch", "kernels", "repo"),
            device="cuda"):
    """All findings from the selected layers, sorted for stable output;
    the dispatch layer runs its probe steps on `device`."""
    out = []
    if "repo" in layers:
        out.extend(check_repo_conventions(root))
    if "kernels" in layers:
        out.extend(check_kernel_contracts(root))
    if "dispatch" in layers:
        out.extend(lint_serve_steps(device=device))
    return sorted(out, key=lambda f: (f.rule, f.file, f.line, f.message))
