"""Findings + the checked-in baseline: the port's copy of the JAX
package's ``analysis/findings.py``.

A ``Finding`` is one rule hit: rule id, ``file:line``, message and a
fix hint. The **baseline** (``analysis/baseline.json``) holds the
grandfathered findings — hits that are understood, justified (each
entry carries a ``reason``) and deliberately not fixed — so CI can
enforce "no NEW findings" from day one without requiring a perfectly
clean tree first. Matching is by ``(rule, file, msg)`` fingerprint,
deliberately line-independent: unrelated edits above a grandfathered
site must not resurrect it.

``python -m distributed_tensorflow_example_tpu_torch.analysis.cli
--write-baseline`` regenerates the file from the current
tree (reasons on surviving entries are preserved); stale entries —
baselined findings the tree no longer produces — are reported so the
baseline shrinks monotonically instead of fossilizing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass
class Finding:
    rule: str
    file: str
    line: int
    msg: str
    hint: str = ""

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.msg)

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "msg": self.msg, "hint": self.hint}

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        out = f"{loc}: [{self.rule}] {self.msg}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def load_baseline(path: str) -> List[Dict[str, Any]]:
    """The baseline's entry list. Raises ValueError on a malformed
    file (the CLI maps that to exit 2 — a corrupt baseline must not
    silently pass the gate as 'no baseline')."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("findings"),
                                                   list):
        raise ValueError(f"{path}: expected "
                         '{"v": 1, "findings": [...]}')
    v = doc.get("v")
    if v != BASELINE_VERSION:
        raise ValueError(f"{path}: baseline version {v!r}, this tool "
                         f"reads v{BASELINE_VERSION}")
    for i, entry in enumerate(doc["findings"]):
        if not isinstance(entry, dict) or not all(
                isinstance(entry.get(k), str)
                for k in ("rule", "file", "msg")):
            raise ValueError(
                f"{path}: findings[{i}] needs string rule/file/msg")
    return doc["findings"]


def write_baseline(path: str, findings: List[Finding],
                   old_entries: List[Dict[str, Any]] | None = None) -> None:
    """Serialize the current findings as the new baseline, carrying
    forward the ``reason`` of any entry that survives."""
    reasons = {}
    for entry in old_entries or []:
        key = (entry["rule"], entry["file"], entry["msg"])
        if entry.get("reason"):
            reasons[key] = entry["reason"]
    entries = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        entry = {"rule": f.rule, "file": f.file, "msg": f.msg,
                 "reason": reasons.get(f.fingerprint(),
                                       "grandfathered (add a reason)")}
        entries.append(entry)
    doc = {"v": BASELINE_VERSION, "findings": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")


def split_by_baseline(findings: List[Finding],
                      entries: List[Dict[str, Any]]
                      ) -> Tuple[List[Finding], List[Finding],
                                 List[Dict[str, Any]]]:
    """(new, baselined, stale_entries). Multiset semantics: N
    identical baseline entries absorb at most N identical findings —
    a duplicated regression still surfaces."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for entry in entries:
        key = (entry["rule"], entry["file"], entry["msg"])
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        key = f.fingerprint()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale = []
    for entry in entries:
        key = (entry["rule"], entry["file"], entry["msg"])
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            stale.append(entry)
    return new, baselined, stale
