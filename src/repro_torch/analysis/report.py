"""Findings model and JSON/console rendering for ``repro_torch.analysis``.

The JSON artifact has the reference's shape (``repro.analysis.report``):
the counts, the rule ids and every finding, so a caller can assert
``violations == 0``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from repro_torch.analysis.invariants import INVARIANTS


@dataclass
class Finding:
    """One rule violation at ``path:line``."""

    rule: str
    path: str
    line: int
    message: str
    severity: str = field(default="error")

    def render(self):
        return "%s:%d: [%s] %s" % (
            self.path, self.line, self.rule, self.message)


def per_rule_counts(findings):
    counts = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return counts


def build_report(findings, files, lockdep_report=None):
    """Assemble the JSON findings payload."""
    payload = {
        "bench": "analysis",
        "violations": len(findings),
        "files_scanned": len(files),
        "rules": sorted(INVARIANTS),
        "per_rule": per_rule_counts(findings),
        "findings": [asdict(f) for f in findings],
    }
    if lockdep_report is not None:
        payload["lockdep"] = lockdep_report
    return payload


def write_json(payload, path):
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def render_console(findings, files):
    lines = [f.render() for f in findings]
    lines.append(
        "repro_torch.analysis: %d file(s) scanned, %d violation(s)" % (
            len(files), len(findings)))
    return "\n".join(lines)
