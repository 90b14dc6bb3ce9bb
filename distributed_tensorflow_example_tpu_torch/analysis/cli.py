"""``dtx-lint`` for the port — the entry point
``python -m distributed_tensorflow_example_tpu_torch.analysis.cli``
(the JAX package's ``dtx-lint`` in torch form; no console script).

Usage::

    python -m distributed_tensorflow_example_tpu_torch.analysis.cli [PATH]
        [--rules r1,r2] [--baseline FILE | --no-baseline]
        [--write-baseline] [--json] [--list-rules]

PATH is the package (or file) to lint; default ``.``. The baseline
defaults to ``<PATH>/analysis/baseline.json`` when present, so linting
``distributed_tensorflow_example_tpu_torch/`` is the whole check. Exit
codes, as JAX's: **0** clean (no non-baselined findings), **1** new
findings, **2** usage/input error (bad path, unreadable baseline,
unknown rule) — so a broken invocation can never masquerade as a clean
tree.

``--json`` emits one machine-readable document (``"ok"`` carries the
verdict), JAX's v1 document.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

from .findings import (Finding, load_baseline, split_by_baseline,
                       write_baseline)
from .index import ModuleIndex
from .rules_contracts import (FlagDriftRule, GaugeDriftRule,
                              SchemaDriftRule, ScopeRegistryRule)
from .rules_loop import HostSyncRule
from .rules_spmd import (AutogradCompleteRule, GroupConsistencyRule,
                         NondeterminismRule, RecaptureRule)

JSON_VERSION = 1

# rule order = presentation order in --list-rules and the docs
ALL_RULES = (
    GroupConsistencyRule(),
    HostSyncRule(),
    SchemaDriftRule(),
    AutogradCompleteRule(),
    RecaptureRule(),
    NondeterminismRule(),
    FlagDriftRule(),
    GaugeDriftRule(),
    ScopeRegistryRule(),
)

# meta rules (not suppressible / not in --rules): broken source and
# broken suppressions are findings themselves
PARSE_RULE = "parse-error"
NOQA_RULE = "noqa-reason"


@dataclass
class LintContext:
    root: str
    repo_root: str
    api_md: str
    readme: str = ""


def _repo_root(root: str) -> str:
    """The directory holding docs/ (and README.md): the lint root itself
    when docs/ lives inside it (linting ``.`` from the repo root), else
    the package directory's parent, else the file's dir."""
    root = os.path.abspath(root)
    if os.path.isfile(root):
        return os.path.dirname(root)
    if os.path.isdir(os.path.join(root, "docs")) \
            or os.path.isfile(os.path.join(root, "bench.py")):
        return root
    return os.path.dirname(root.rstrip(os.sep))


def collect_findings(index: ModuleIndex, ctx: LintContext,
                     rule_ids: Optional[List[str]] = None
                     ) -> List[Finding]:
    findings: List[Finding] = []
    for relpath, line, msg in index.parse_errors:
        findings.append(Finding(
            rule=PARSE_RULE, file=relpath, line=line,
            msg=f"file does not parse: {msg}",
            hint="fix the syntax error; unparsable files are unlinted"))
    for mod in index.modules.values():
        for nq in mod.noqa.values():
            if not nq.reason:
                findings.append(Finding(
                    rule=NOQA_RULE, file=mod.relpath, line=nq.line,
                    msg=("suppression without a reason: "
                         "# dtx: noqa[...] needs a justification after "
                         "the bracket"),
                    hint=("say WHY the finding is acceptable — an "
                          "unexplained suppression is the drift this "
                          "linter exists to stop")))
    for rule in ALL_RULES:
        if rule_ids is not None and rule.id not in rule_ids:
            continue
        findings.extend(rule.check(index, ctx))
    return findings


def apply_noqa(index: ModuleIndex, findings: List[Finding]):
    """(kept, suppressed): a finding is suppressed by a
    ``# dtx: noqa[rule]`` (with a reason) on its own line."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.rule in (PARSE_RULE, NOQA_RULE):
            kept.append(f)
            continue
        mod = index.modules.get(f.file)
        nq = mod.noqa_for(f.line) if mod is not None else None
        if nq is not None and nq.reason and (
                f.rule in nq.rules or "all" in nq.rules):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


def run_lint(root: str, rule_ids: Optional[List[str]] = None):
    """(index, ctx, kept, suppressed) over one tree — the library
    surface tests and future gates use."""
    index = ModuleIndex.build(root)
    repo_root = _repo_root(root)
    ctx = LintContext(root=os.path.abspath(root), repo_root=repo_root,
                      api_md=os.path.join(repo_root, "docs", "API.md"),
                      readme=os.path.join(repo_root, "README.md"))
    # no bench.py aux file: the repo-root bench.py is the JAX package's,
    # and the port has no bench of its own yet
    findings = collect_findings(index, ctx, rule_ids)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.msg))
    kept, suppressed = apply_noqa(index, findings)
    return index, ctx, kept, suppressed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtx-lint",
        description=("repo-aware static analysis of the PyTorch port: "
                     "process groups at collectives, hot-loop host "
                     "syncs, schema/flag/gauge/scope drift, "
                     "autograd.Function completeness, recapture and "
                     "global-RNG hazards"))
    p.add_argument("path", nargs="?", default=".",
                   help="package directory or file to lint (default .)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default all)")
    p.add_argument("--baseline", default=None,
                   help=("baseline JSON (default: "
                         "<path>/analysis/baseline.json when present)"))
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: every finding is new")
    p.add_argument("--write-baseline", action="store_true",
                   help=("write the current findings as the baseline "
                         "and exit 0 (reasons on surviving entries are "
                         "kept)"))
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (for gating)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:18s} {rule.doc}")
        print(f"{PARSE_RULE:18s} unparsable source file (not "
              f"suppressible)")
        print(f"{NOQA_RULE:18s} # dtx: noqa[...] without a reason (not "
              f"suppressible)")
        return 0

    root = args.path
    if not os.path.exists(root):
        print(f"dtx-lint: path {root!r} does not exist", file=sys.stderr)
        return 2

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        known = {r.id for r in ALL_RULES}
        unknown = [r for r in rule_ids if r not in known]
        if unknown:
            print(f"dtx-lint: unknown rule(s) {unknown}; see "
                  f"--list-rules", file=sys.stderr)
            return 2

    index, ctx, findings, suppressed = run_lint(root, rule_ids)

    baseline_path = args.baseline
    if baseline_path is None and os.path.isdir(root):
        cand = os.path.join(root, "analysis", "baseline.json")
        if os.path.isfile(cand) or args.write_baseline:
            baseline_path = cand

    if args.write_baseline:
        if not baseline_path:
            print("dtx-lint: --write-baseline needs --baseline FILE "
                  "when linting a single file", file=sys.stderr)
            return 2
        if rule_ids is not None:
            # a subset run sees only its own rules' findings; writing
            # it out would silently DROP every other rule's
            # grandfathered entries (and their reasons)
            print("dtx-lint: --write-baseline with --rules would "
                  "discard the other rules' baseline entries; run "
                  "without --rules", file=sys.stderr)
            return 2
        old = []
        if os.path.isfile(baseline_path):
            try:
                old = load_baseline(baseline_path)
            except (ValueError, OSError):
                old = []
        os.makedirs(os.path.dirname(baseline_path) or ".",
                    exist_ok=True)
        write_baseline(baseline_path, findings, old)
        print(f"dtx-lint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    entries = []
    if baseline_path and not args.no_baseline:
        try:
            entries = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"dtx-lint: cannot read baseline: {e}",
                  file=sys.stderr)
            return 2
    new, baselined, stale = split_by_baseline(findings, entries)

    if args.as_json:
        doc = {
            "v": JSON_VERSION,
            "root": ctx.root,
            "rules": [r.id for r in ALL_RULES
                      if rule_ids is None or r.id in rule_ids],
            "modules": len(index.modules),
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "suppressed": len(suppressed),
            "stale_baseline": stale,
            "ok": not new,
        }
        print(json.dumps(doc, indent=2))
        return 1 if new else 0

    for f in new:
        print(f.render())
    for entry in stale:
        print(f"note: stale baseline entry (no longer produced): "
              f"[{entry['rule']}] {entry['file']}: {entry['msg']}")
    print(f"dtx-lint: {len(index.modules)} module(s), "
          f"{len(new)} new finding(s), {len(baselined)} baselined, "
          f"{len(suppressed)} suppressed"
          + (f", {len(stale)} stale baseline entr"
             f"{'y' if len(stale) == 1 else 'ies'}" if stale else ""))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
