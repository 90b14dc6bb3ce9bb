"""Contract rules: schema drift, flag/doc drift, gauge drift, scope
registry — the JAX package's ``analysis/rules_contracts.py`` over the
port's modules.

These rules pin the repo's stringly-typed contracts — the telemetry
schema (``obs/schema.py``), the CLI flag surface vs ``docs/API.md`` (the
port's own ``--device`` vs the README's port section), the ``dtx_*``
gauges vs ``docs/observability.md``, and the trace-scope/bucket
registry (``obs/buckets.py``) — by
statically extracting the keys each side produces/consumes and
diffing them. All extraction is AST-only: dict literal keys,
``x["key"] = ...`` subscript stores and call keyword names, plus the
bucket-registry expansion for keys built as ``f"{bucket}_s"``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from .findings import Finding
from .index import Module, ModuleIndex


def produced_keys(mod: Module) -> Set[str]:
    """Every string key this module statically produces: dict literal
    keys, subscript-store keys, and call keyword names."""
    keys: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    keys.add(k.value)
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg:
                    keys.add(kw.arg)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.slice, ast.Constant) and isinstance(
                            t.slice.value, str):
                    keys.add(t.slice.value)
    return keys


def _bucket_expansion(index: ModuleIndex, mod: Module) -> Set[str]:
    """Keys built as ``f"{bucket}_s"`` over the shared registry: when
    a writer module imports WINDOW_BUCKETS/HOST_BUCKET, its produced
    set gains the expanded field names."""
    refs = set(mod.from_imports) | set(mod.const_nodes)
    if not ({"WINDOW_BUCKETS", "HOST_BUCKET"} & refs):
        return set()
    buckets_mod = index.module_by_suffix("obs/buckets.py")
    if buckets_mod is None:
        return set()
    out: Set[str] = set()
    for name in ("WINDOW_BUCKETS", "HOST_BUCKET"):
        node = index.resolve_constant(buckets_mod, name)
        if node is None:
            continue
        lits, _ = index.resolve_strings(buckets_mod, node)
        out |= {f"{b}_s" for b in lits}
    return out


def _contract_dict(mod: Module, name: str) -> Optional[ast.Dict]:
    node = mod.const_nodes.get(name)
    return node if isinstance(node, ast.Dict) else None


def _contract_keys(d: ast.Dict) -> List[ast.Constant]:
    return [k for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


class SchemaDriftRule:
    """rule 3: every field the obs/schema.py contracts promise must
    have a statically-visible writer, and every obs/compare.py gate
    metric must have a statically-visible producer."""

    id = "schema-drift"
    doc = ("obs/schema.py contract fields and obs/compare.py gate "
           "metrics must have statically-visible writers/producers")

    # contract name -> writer module suffixes
    CONTRACT_WRITERS = {
        "METRICS_COMMON": ("obs/metrics.py", "train/loop.py"),
        "METRICS_WINDOW": ("obs/metrics.py", "train/loop.py"),
        "METRICS_EVENT": ("obs/metrics.py", "train/loop.py"),
        "FLIGHT_DUMP": ("obs/flight.py",),
        "FLIGHT_STEP_RECORD": ("obs/flight.py", "train/loop.py"),
        "FLIGHT_ANOMALY_RECORD": ("obs/flight.py", "obs/anomaly.py"),
        "RUN_REPORT": ("obs/aggregate.py",),
        "SERVING_STATS": ("serving/engine.py",),
        # span rows: the envelope is written by the recorder, the
        # payload fields by the two emitting layers (the scheduler's
        # admission narration + the engine's execution milestones)
        "SPAN_COMMON": ("obs/spans.py",),
        # v7 widens the writer set: the train loop emits phase spans
        # (phase/trace_id/dur_ms), the collector stamps source on
        # merged rows, and the engine threads trace_id/parent_id;
        # v9 adds the fleet router's route/failover narration
        # (replica/attempt); v10 adds the replay module's replay_of
        # stamp (serving/replay.py builds the recorder extra) and the
        # scheduler's fingerprint payload
        "SPAN_FIELDS": ("serving/scheduler.py", "serving/engine.py",
                        "train/loop.py", "obs/collector.py",
                        "serving/router.py", "serving/replay.py"),
        "FLEET_REPORT": ("obs/collector.py",),
        "HISTORY_ENTRY": ("obs/history.py",),
        # restart-timeline rows: the envelope is written by the
        # narrator (resilience/restart.py); the loop's preempt/
        # resumed/snapshot narration rides the same emit
        "RESTART_EVENT": ("resilience/restart.py",),
        # v8 documents: the per-request latency waterfall and the
        # history change-point report
        "WATERFALL": ("obs/waterfall.py",),
        "DRIFT_REPORT": ("obs/drift.py",),
        # v10 documents: the captured workload (obs/workload.py
        # distills a span dir into the portable request schedule
        # dtx-serve --replay and dtx-obs capacity consume)
        "WORKLOAD": ("obs/workload.py",),
        "WORKLOAD_REQUEST": ("obs/workload.py",),
    }
    # JAX's list less the repo-root bench.py, which is the JAX bench:
    # the gate's keys are bench metrics, so the check runs once the
    # port has a bench of its own in the linted tree (with it as a
    # producer) and is idle until then
    GATE_PRODUCERS = ("obs/aggregate.py", "obs/metrics.py",
                      "obs/schema.py", "train/loop.py")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        out: List[Finding] = []
        schema_mod = index.module_by_suffix("obs/schema.py")
        if schema_mod is not None:
            out.extend(self._check_contracts(index, schema_mod))
            out.extend(self._check_version_bump(index, schema_mod,
                                               ctx))
        compare_mod = index.module_by_suffix("obs/compare.py")
        if compare_mod is not None:
            out.extend(self._check_gate(index, compare_mod))
        return out

    def _check_version_bump(self, index: ModuleIndex,
                            schema_mod: Module, ctx) -> List[Finding]:
        """A SCHEMA_VERSION bump is a three-sided contract change:
        the history comment in obs/schema.py must narrate the new
        version, docs/observability.md must document it, and the
        CONTRACT_WRITERS registry here must be revisited (its comment
        names the version whose documents it last absorbed).  A bump
        that touches only the integer drifts all three — this check
        makes the co-touch mechanical (v10 is the first fixture)."""
        node = schema_mod.const_nodes.get("SCHEMA_VERSION")
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, int)):
            return []
        tag = f"v{node.value}"
        findings: List[Finding] = []
        # (a) the schema's own history comment: the tag must appear
        # on some line other than the assignment itself
        assign_line = node.lineno
        if not any(tag in text for i, text in
                   enumerate(schema_mod.lines, 1) if i != assign_line):
            findings.append(Finding(
                rule=self.id, file=schema_mod.relpath,
                line=assign_line,
                msg=(f"SCHEMA_VERSION = {node.value} but the version-"
                     f"history comment never mentions {tag}"),
                hint=(f"append a '# {tag} = ...' entry describing "
                      f"what the bump changed — the history comment "
                      f"is the migration narrative")))
        # (b) docs/observability.md documents the new version
        api_md = getattr(ctx, "api_md", None)
        obs_md = (os.path.join(os.path.dirname(api_md),
                               "observability.md") if api_md else "")
        if obs_md and os.path.isfile(obs_md):
            with open(obs_md, encoding="utf-8") as f:
                words = set(re.findall(r"[A-Za-z0-9_]+", f.read()))
            if tag not in words:
                findings.append(Finding(
                    rule=self.id, file=schema_mod.relpath,
                    line=assign_line,
                    msg=(f"SCHEMA_VERSION = {node.value} but "
                         f"docs/observability.md never mentions "
                         f"{tag}"),
                    hint=("document the new schema version's "
                          "documents/fields in docs/observability.md "
                          "in the same tree as the bump")))
        # (c) the CONTRACT_WRITERS registry here was revisited: a
        # comment in this module names the bumped version (absorbing
        # the new documents into the writer map is part of the bump)
        me = index.module_by_suffix("analysis/rules_contracts.py")
        lines = me.lines if me is not None else []
        if not lines:
            try:
                with open(__file__, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                lines = []
        if lines and not any(tag in text for text in lines):
            findings.append(Finding(
                rule=self.id, file=schema_mod.relpath,
                line=assign_line,
                msg=(f"SCHEMA_VERSION = {node.value} but "
                     f"analysis/rules_contracts.py CONTRACT_WRITERS "
                     f"was never revisited for {tag}"),
                hint=("absorb the bump's new/changed documents into "
                      "CONTRACT_WRITERS (a comment naming the "
                      "version records the revisit)")))
        return findings

    def _writer_keys(self, index: ModuleIndex,
                     suffixes) -> Optional[Set[str]]:
        keys: Set[str] = set()
        found = False
        for suffix in suffixes:
            mod = index.module_by_suffix(suffix)
            if mod is None:
                continue
            found = True
            keys |= produced_keys(mod)
            keys |= _bucket_expansion(index, mod)
        return keys if found else None

    def _check_contracts(self, index: ModuleIndex,
                         schema_mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for contract, suffixes in self.CONTRACT_WRITERS.items():
            d = _contract_dict(schema_mod, contract)
            if d is None:
                continue
            writers = self._writer_keys(index, suffixes)
            if writers is None:
                continue  # writer modules absent from this tree
            for key_node in _contract_keys(d):
                key = key_node.value
                if key not in writers:
                    findings.append(Finding(
                        rule=self.id, file=schema_mod.relpath,
                        line=key_node.lineno,
                        msg=(f"{contract} field {key!r} has no "
                             f"statically-visible writer in "
                             f"{'/'.join(suffixes)}"),
                        hint=("either the writer renamed/dropped the "
                              "field (bump SCHEMA_VERSION and update "
                              "the contract) or the contract promises "
                              "a field nobody emits")))
        return findings

    def _check_gate(self, index: ModuleIndex,
                    compare_mod: Module) -> List[Finding]:
        d = _contract_dict(compare_mod, "GATE_METRICS")
        if d is None:
            return []
        bench = index.module_by_suffix("bench.py")
        if bench is None:
            return []  # no bench script in this tree: the gate is idle
        producers = self._writer_keys(
            index, self.GATE_PRODUCERS + ("bench.py",)) or set()
        findings: List[Finding] = []
        for key_node in _contract_keys(d):
            key = key_node.value
            if key not in producers:
                findings.append(Finding(
                    rule=self.id, file=compare_mod.relpath,
                    line=key_node.lineno,
                    msg=(f"GATE_METRICS key {key!r} is produced by "
                         f"neither bench.py nor the obs writers — the "
                         f"gate silently stops holding it"),
                    hint=("re-point the gate at the metric's new name "
                          "or drop the stale key")))
        return findings


def readme_port_words(readme: str) -> Optional[Set[str]]:
    """The words of the README's port section (its ``## PyTorch/CUDA
    port`` heading up to the next ``## `` heading), None when absent."""
    if not readme or not os.path.isfile(readme):
        return None
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## PyTorch/CUDA port\b(.*?)(?=^## |\Z)", text,
                  re.M | re.S)
    return set(re.findall(r"[A-Za-z0-9_]+", m.group(1))) if m else None


class FlagDriftRule:
    """rule 7: every argparse flag in config.py must be mentioned in
    docs/API.md (bare field name or --flag form both count); the flags
    only the port has (``--device``) in the README's port section
    instead, which docs/API.md (the JAX package's) does not cover."""

    id = "flag-drift"
    doc = ("config.py argparse flags must be covered by docs/API.md "
           "(the port's own --device by the README's port section)")

    PORT_ONLY_FLAGS = ("device",)

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        cfg = index.module_by_suffix("config.py")
        api_md = getattr(ctx, "api_md", None)
        if cfg is None or not api_md or not os.path.isfile(api_md):
            return []
        with open(api_md, encoding="utf-8") as f:
            words = set(re.findall(r"[A-Za-z0-9_]+", f.read()))
        readme = getattr(ctx, "readme", "")
        port_words = readme_port_words(readme)
        findings: List[Finding] = []
        for node in ast.walk(cfg.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            raw = node.args[0].value
            if not raw.startswith("--"):
                continue
            flag = raw.lstrip("-")
            if flag in self.PORT_ONLY_FLAGS:
                if port_words is not None and flag not in port_words:
                    findings.append(Finding(
                        rule=self.id, file=cfg.relpath, line=node.lineno,
                        msg=(f"port flag --{flag} is not mentioned in "
                             f"{os.path.basename(readme)}'s PyTorch/CUDA "
                             f"port section"),
                        hint=("document it in the README's port section "
                              "(docs/API.md is the JAX package's)")))
                continue
            if flag not in words:
                findings.append(Finding(
                    rule=self.id, file=cfg.relpath, line=node.lineno,
                    msg=(f"flag --{flag} is not mentioned anywhere in "
                         f"{os.path.basename(api_md)}"),
                    hint=("add it to the docs/API.md flag coverage (the "
                          "bare field name anywhere in the file "
                          "counts)")))
        return findings


class GaugeDriftRule:
    """rule 10: every ``dtx_*`` Prometheus gauge obs/serve.py emits
    must be mentioned in docs/observability.md — the scrape surface
    is an API, and an undocumented gauge is a dashboard nobody can
    build (the flag-drift discipline, applied to /metrics)."""

    id = "gauge-drift"
    doc = ("obs/serve.py dtx_* gauges must be covered by "
           "docs/observability.md")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        serve = index.module_by_suffix("obs/serve.py")
        api_md = getattr(ctx, "api_md", None)
        if serve is None or not api_md:
            return []
        obs_md = os.path.join(os.path.dirname(api_md),
                              "observability.md")
        if not os.path.isfile(obs_md):
            return []
        with open(obs_md, encoding="utf-8") as f:
            words = set(re.findall(r"[A-Za-z0-9_]+", f.read()))
        findings: List[Finding] = []
        seen: Set[str] = set()
        for node in ast.walk(serve.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "gauge"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if not name.startswith("dtx_") or name in seen:
                continue
            seen.add(name)
            if name not in words:
                findings.append(Finding(
                    rule=self.id, file=serve.relpath, line=node.lineno,
                    msg=(f"gauge {name} is not mentioned anywhere in "
                         f"{os.path.basename(obs_md)}"),
                    hint=("document it in docs/observability.md (the "
                          "bare gauge name anywhere in the file "
                          "counts) or drop the emission")))
        return findings


class ScopeRegistryRule:
    """rule 8: tracer.annotate / WindowTimer.charge / obs/tracer.scope
    string literals must come from the obs/buckets.py registry
    (``scope`` opens the regions JAX names with ``jax.named_scope``)."""

    id = "scope-registry"
    doc = ("annotate()/charge()/scope() literals must be "
           "obs/buckets.py registry names")

    # method name -> (registry constant, label)
    SITES = {
        "annotate": ("TRACE_SCOPES", "trace scope"),
        "charge": ("WINDOW_BUCKETS", "window bucket"),
        "scope": ("NAMED_SCOPES", "named scope"),
    }

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        buckets_mod = index.module_by_suffix("obs/buckets.py")
        if buckets_mod is None:
            return []
        registries: Dict[str, Optional[Set[str]]] = {}
        for const, _ in self.SITES.values():
            vals = index.resolve_string_tuple(buckets_mod, const)
            registries[const] = set(vals) if vals is not None else None
        findings: List[Finding] = []
        for mod in index.modules.values():
            if mod is buckets_mod:
                continue
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self.SITES
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                const, label = self.SITES[node.func.attr]
                reg = registries.get(const)
                if reg is None:
                    continue
                name = node.args[0].value
                if name not in reg:
                    findings.append(Finding(
                        rule=self.id, file=mod.relpath, line=node.lineno,
                        msg=(f"{label} {name!r} is not in "
                             f"obs/buckets.py {const} {sorted(reg)}"),
                        hint=("add it to the registry (ONE source of "
                              "truth) or fix the call site's name — a "
                              "drifted literal splits one cost across "
                              "two names")))
        return findings
