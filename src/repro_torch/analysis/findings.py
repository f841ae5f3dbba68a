"""Finding records, JSON output, and the baseline ratchet: a copy of
`repro.analysis.findings` (same `Finding`, same JSON schema, which
`obs.regress`'s `analysis.findings_*` specs read).

A `Finding` is one rule violation at one site. Its identity for the
ratchet is `(rule, file, message)` — deliberately NOT the line number,
which drifts with every unrelated edit; a baselined finding stays
baselined until the violating code (or the rule) actually changes.

The gate contract (`__main__.py --gate`): findings whose key appears in
the committed baseline are *known debt* and pass; any finding outside
it is NEW and fails the gate. Baseline entries with no matching current
finding are *stale* — reported so the baseline can shrink, never grow
silently. An empty baseline (the committed state for `src/repro_torch`,
`analysis/baseline_torch.json`) therefore means the gate fails on the
first violation anywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

SCHEMA_VERSION = 1

#: severity levels in gate order — only "error" findings fail the gate
SEVERITIES = ("error", "warning")

FindingKey = Tuple[str, str, str]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "JX002", "KC201", "RL201"
    file: str          # repo-relative path (or "<dispatch:decode>" probes)
    line: int          # 1-based; 0 when the site has no source line
    severity: str      # "error" | "warning"
    message: str

    @property
    def key(self) -> FindingKey:
        return (self.rule, self.file, self.message)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")


def load_baseline(path: str) -> List[FindingKey]:
    """Baseline keys; a missing file is an empty baseline (strict)."""
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        blob = json.load(fh)
    return [
        (str(e["rule"]), str(e["file"]), str(e["message"]))
        for e in blob.get("findings", [])
    ]


def diff_findings(
    findings: Sequence[Finding], baseline: Iterable[FindingKey]
) -> Tuple[List[Finding], List[FindingKey]]:
    """(new findings not in baseline, stale baseline keys not seen)."""
    base = set(baseline)
    current = {f.key for f in findings}
    new = [f for f in findings if f.key not in base]
    stale = sorted(base - current)
    return new, stale


def count_by(findings: Sequence[Finding], attr: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        k = getattr(f, attr)
        out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def write_findings_json(
    path: str,
    findings: Sequence[Finding],
    new: Sequence[Finding],
    stale: Sequence[FindingKey],
    baseline_path: str,
) -> Dict[str, object]:
    """The CI artifact: every finding plus the ratchet bookkeeping the
    regression history records (`obs.regress`) pick their counts from."""
    blob: Dict[str, object] = {
        "schema": SCHEMA_VERSION,
        "baseline": baseline_path,
        "counts": {
            "total": len(findings),
            "new": len(new),
            "stale_baseline": len(stale),
            "by_rule": count_by(findings, "rule"),
            "by_severity": count_by(findings, "severity"),
        },
        "findings": [f.to_dict() for f in findings],
        "new": [f.to_dict() for f in new],
        "stale_baseline": [
            {"rule": r, "file": f, "message": m} for r, f, m in stale
        ],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return blob
