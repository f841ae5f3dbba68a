"""CLI: `python -m repro_torch.analysis [--gate]` (DESIGN.md §15).

Runs the selected layers, writes the findings JSON artifact
(`results/analysis_findings_torch.json`), diffs against the committed
baseline (`analysis/baseline_torch.json`, beside the reference's), and
— with `--gate` — exits nonzero iff any finding is NEW (not baselined).
Stale baseline entries are reported so the baseline only ever shrinks.
The dispatch layer runs its probe steps on the card unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..models.common import resolve_device
from . import run_all
from .findings import diff_findings, load_baseline, write_findings_json

_LAYERS = ("repo", "kernels", "dispatch")


def _default_root() -> str:
    """The repo root this package came from (src/repro_torch/analysis ->
    three levels up), falling back to the cwd."""
    here = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")
    )
    if os.path.isdir(os.path.join(here, "src", "repro_torch")):
        return here
    return os.getcwd()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="three-layer static analysis of the port's serving "
                    "stack (dispatch lint, CUDA kernel contracts, repo "
                    "conventions)",
    )
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--layers", default=",".join(_LAYERS),
                    help="comma list from {repo,kernels,dispatch}")
    ap.add_argument("--json", default=None,
                    help="findings JSON path (default: "
                         "<root>/results/analysis_findings_torch.json)")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: "
                         "<root>/analysis/baseline_torch.json; missing "
                         "file = empty baseline)")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 if any finding is not in the baseline")
    ap.add_argument("--device", default="cuda",
                    help="where the dispatch layer runs its probe steps "
                         "(default: the card; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root or _default_root())
    layers = tuple(
        l.strip() for l in args.layers.split(",") if l.strip()
    )
    bad = set(layers) - set(_LAYERS)
    if bad:
        ap.error(f"unknown layers: {sorted(bad)} (choose from {_LAYERS})")
    device = resolve_device(args.device) if "dispatch" in layers else None
    json_path = args.json or os.path.join(
        root, "results", "analysis_findings_torch.json"
    )
    baseline_path = args.baseline or os.path.join(
        root, "analysis", "baseline_torch.json"
    )

    findings = run_all(root, layers=layers, device=device)
    baseline = load_baseline(baseline_path)
    new, stale = diff_findings(findings, baseline)
    write_findings_json(json_path, findings, new, stale, baseline_path)

    print(f"repro_torch.analysis: layers={','.join(layers)} root={root}")
    print(f"  {len(findings)} finding(s), {len(new)} new, "
          f"{len(stale)} stale baseline entr(ies) -> {json_path}")
    for f in findings:
        mark = "NEW " if f in new else "base"
        print(f"  [{mark}] {f}")
    for rule, file, message in stale:
        print(f"  [stale] {file}: {rule} no longer fires ({message}) — "
              "shrink the baseline")
    if args.gate and new:
        print(f"GATE FAIL: {len(new)} new finding(s) not in "
              f"{baseline_path}", file=sys.stderr)
        return 1
    if args.gate:
        print("GATE PASS: no new findings")
    return 0


def entry() -> None:
    """`repro-torch-analyze` console-script entry point."""
    raise SystemExit(main())


if __name__ == "__main__":
    raise SystemExit(main())
