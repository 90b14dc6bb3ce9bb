"""Declarative serving SLOs with multi-window burn-rate evaluation — the
port's copy of the JAX package's ``obs/slo.py``.

- An **SLO spec** promises that an ``objective`` fraction of requests
  (default 99%) is good: a latency metric (``ttft_ms`` / ``latency_ms``)
  under its ``threshold_ms``, or simply not erroring for ``error``.
- The **burn rate** over a window is the observed bad fraction over the
  error budget (``1 - objective``): 1.0 spends the budget exactly as
  fast as allowed.
- A **breach** needs the burn rate over both a fast and a slow sliding
  window at or above ``burn_threshold`` (the multi-window rule).

Windows slide over the scheduler's tick index, not wall time, so the
verdict is deterministic.  Records come from the span stream
(``records_from_spans``); ``evaluate`` is a pure function over them.
The engine's brownout and the router's health probe read the fast
window's burn rate, the status server's ``/slo`` the whole document;
``fleet_evaluate`` is the federated form over a merged multi-source
stream (the fleet report's ``slo`` section).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

from .schema import SCHEMA_VERSION

# sliding-window defaults, in scheduler ticks; burn_threshold 1.0 =
# breach when the budget burns at (or above) exactly its sustainable
# rate on both windows
FAST_WINDOW = 64
SLOW_WINDOW = 512
BURN_THRESHOLD = 1.0

# spec-DSL metric name -> the per-request record field it bounds
_METRIC_FIELDS = {
    "ttft_p99_ms": "ttft_ms",
    "latency_p99_ms": "latency_ms",
    "error_rate": "error",
}


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective.  ``metric`` is the per-request
    field (``ttft_ms``/``latency_ms``/``error``); latency metrics
    bound each request by ``threshold_ms``, ``error`` counts engine
    failures.  ``objective`` is the promised good fraction."""

    name: str
    metric: str                     # ttft_ms | latency_ms | error
    threshold_ms: Optional[float]   # None for the error metric
    objective: float = 0.99
    fast_window: int = FAST_WINDOW
    slow_window: int = SLOW_WINDOW
    burn_threshold: float = BURN_THRESHOLD

    def bad(self, rec: Dict[str, Any]) -> bool:
        """Does this request burn budget under this SLO?  An errored
        request is bad under every SLO (it delivered nothing)."""
        if rec.get("error"):
            return True
        if self.metric == "error":
            return False
        v = rec.get(self.metric)
        if v is None:
            # retired without the measurement (torn stream): count it
            # bad — absence of evidence must not look like health
            return True
        return float(v) > float(self.threshold_ms)


DEFAULT_SLOS = (
    SLOSpec("ttft_p99_ms", "ttft_ms", 500.0),
    SLOSpec("latency_p99_ms", "latency_ms", 5000.0),
    SLOSpec("error_rate", "error", None, objective=0.99),
)


def parse_specs(text: str) -> List[SLOSpec]:
    """Parse the ``--slo`` DSL: comma-separated ``NAME<=VALUE`` with
    NAME one of ttft_p99_ms / latency_p99_ms / error_rate (VALUE: ms
    for the latency pair, the max bad fraction for error_rate).
    Empty input yields DEFAULT_SLOS.  Raises ValueError with the
    offending spec on malformed input."""
    text = (text or "").strip()
    if not text:
        return list(DEFAULT_SLOS)
    out: List[SLOSpec] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("<=")
        name = name.strip()
        if not sep or name not in _METRIC_FIELDS:
            raise ValueError(
                f"bad SLO spec {part!r} (want NAME<=VALUE with NAME "
                f"one of {sorted(_METRIC_FIELDS)})")
        try:
            v = float(val)
        except ValueError:
            raise ValueError(f"bad SLO value in {part!r}")
        if name == "error_rate":
            if not 0.0 < v < 1.0:
                raise ValueError(
                    f"error_rate bound {v} must be in (0, 1)")
            out.append(SLOSpec(name, "error", None, objective=1.0 - v))
        else:
            if v <= 0:
                raise ValueError(f"threshold in {part!r} must be > 0")
            out.append(SLOSpec(name, _METRIC_FIELDS[name], v))
    return out


def records_from_spans(rows: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-request SLO records from a span stream: one dict per
    request that REACHED a terminal state, carrying ``retire_tick``,
    ``ttft_ms``, ``latency_ms``, ``error`` and its typed
    ``terminal`` (result / timeout / shed / failed).  A ``timeout``
    or ``failed`` terminal is an errored request — it delivered
    nothing within its contract — so it burns budget under every SLO;
    ``shed`` records ride along for ``evaluate``'s separate shed rate
    but are EXCLUDED from the SLO windows (a typed 503 is the
    admission policy working, not the service breaking its latency
    promise).  In-flight requests are excluded — they haven't
    consumed budget yet.  So are non-shed records with no ``submit``
    event: the /slo surface reads bounded TAILS, and a long-running
    server's oldest lifecycle heads scroll out — a retire whose
    submit was truncated away is missing its measurements by
    TRUNCATION, not by failure, and must not read as bad (events are
    time-ordered, so submit-in-tail implies the rest of the lifecycle
    is too)."""
    from .spans import reconstruct

    out = []
    for (proc, rid), rec in sorted(reconstruct(rows).items()):
        err = rec.get("error")
        terminal = rec.get("terminal")
        if terminal is None and not err:
            continue
        if "submit_t" not in rec and terminal != "shed":
            continue
        rt = rec.get("retire_tick")
        if rt is None:
            rt = rec.get("timeout_tick")
        if rt is None:
            rt = rec.get("shed_tick")
        if rt is None:
            # an errored request may never have retired; pin it to the
            # last tick it touched (or 0) so windows include it
            ticks = rec.get("ticks") or []
            rt = ticks[-1] if ticks else 0
        out.append({
            "proc": proc,
            "rid": rid,
            # the fleet collector's source stamp (None on a
            # single-engine stream) — fleet_evaluate groups on it
            "source": rec.get("source"),
            "terminal": terminal or "failed",
            "retire_tick": int(rt),
            "ttft_ms": rec.get("ttft_ms"),
            "latency_ms": rec.get("latency_ms"),
            # timeout/failed burn budget under every SLO (the typed
            # non-delivery terminals); shed is handled separately
            "error": bool(err) or terminal in ("timeout", "failed"),
        })
    return out


def _percentile(vals: List[float], q: float) -> Optional[float]:
    # np.percentile (linear interpolation), the definition
    # serving/engine.stats() uses, so the two agree on the same data
    if not vals:
        return None
    import numpy as np

    return float(np.percentile(vals, q * 100.0))


def evaluate(records: List[Dict[str, Any]],
             specs: Optional[Iterable[SLOSpec]] = None,
             now_tick: Optional[int] = None) -> Dict[str, Any]:
    """Evaluate every spec over the records' sliding tick windows.

    Pure and closed-form: given the same records and ``now_tick`` the
    verdict is bit-identical.
    ``now_tick`` defaults to the newest ``retire_tick`` observed.

    Shed requests (terminal "shed") are carved out before the SLO
    windows slide: a typed 503 is admission control doing its job,
    not a latency/error-budget burn — they get their OWN rate in the
    returned ``shed`` section (count + shed fraction of all terminals
    per window)."""
    specs = list(DEFAULT_SLOS if specs is None else specs)
    if now_tick is None:
        now_tick = max((r["retire_tick"] for r in records), default=0)
    shed_records = [r for r in records
                    if r.get("terminal") == "shed"]
    records = [r for r in records if r.get("terminal") != "shed"]
    slos: List[Dict[str, Any]] = []
    breaches: List[str] = []
    for spec in specs:
        windows: Dict[str, Dict[str, Any]] = {}
        burning = []
        for label, w in (("fast", spec.fast_window),
                         ("slow", spec.slow_window)):
            inside = [r for r in records
                      if r["retire_tick"] > now_tick - w]
            bad = sum(1 for r in inside if spec.bad(r))
            n = len(inside)
            bad_frac = (bad / n) if n else 0.0
            budget = 1.0 - spec.objective
            # rounded ONCE and compared rounded: the displayed burn
            # rate and the breach decision must agree (1 - 0.99 is
            # not exactly 0.01 in floats)
            burn = round(bad_frac / budget, 6) if budget > 0 else 0.0
            windows[label] = {
                "window_ticks": w, "requests": n, "bad": bad,
                "bad_frac": round(bad_frac, 6),
                "burn_rate": burn,
            }
            burning.append(n > 0 and burn >= spec.burn_threshold)
        doc: Dict[str, Any] = {
            "name": spec.name, "metric": spec.metric,
            "threshold_ms": spec.threshold_ms,
            "objective": spec.objective,
            "burn_threshold": spec.burn_threshold,
            "windows": windows,
            # both windows must burn: the multi-window AND
            "breach": all(burning),
        }
        if spec.metric != "error":
            slow = [float(r[spec.metric]) for r in records
                    if r["retire_tick"] > now_tick - spec.slow_window
                    and isinstance(r.get(spec.metric), (int, float))]
            doc["observed_p99_ms"] = _percentile(slow, 0.99)
        if doc["breach"]:
            breaches.append(spec.name)
        slos.append(doc)
    # shed's own rate over the slow window: shed / (shed + served)
    # among terminals inside the window — the load-shedding pressure
    # signal, deliberately NOT an SLO breach input
    w = max((s.slow_window for s in specs), default=SLOW_WINDOW)
    shed_in = sum(1 for r in shed_records
                  if r["retire_tick"] > now_tick - w)
    served_in = sum(1 for r in records
                    if r["retire_tick"] > now_tick - w)
    shed_doc = {
        "window_ticks": w,
        "shed": shed_in,
        "terminals": shed_in + served_in,
        "rate": (round(shed_in / (shed_in + served_in), 6)
                 if shed_in + served_in else 0.0),
    }
    return {
        "v": SCHEMA_VERSION,
        "kind": "slo_report",
        "now_tick": int(now_tick),
        "requests": len(records),
        "shed": shed_doc,
        "slos": slos,
        "breaches": breaches,
        "ok": not breaches,
    }


def _source_of(rec: Dict[str, Any]) -> str:
    """A record's fleet-source label: the collector's ``source`` stamp
    when present, else the process index (a single-dir multi-proc run
    federates per process)."""
    src = rec.get("source")
    return str(src) if src else f"proc{rec.get('proc', 0)}"


def fleet_evaluate(records: List[Dict[str, Any]],
                   specs: Optional[Iterable[SLOSpec]] = None,
                   now_tick: Optional[int] = None) -> Dict[str, Any]:
    """Federated SLO evaluation over a merged multi-source stream.

    Evaluates the fleet (the union of every source's records) and each
    source separately, all against ONE shared ``now_tick`` (the newest
    retire_tick fleet-wide) — the alignment that makes the closed-form
    identity exact: because the per-source record sets PARTITION the
    fleet set inside every window, the fleet's bad/request counts are
    the integer sums of the per-source counts, and the fleet burn rate
    is exactly ``round((Σ bad_s / Σ n_s) / budget, 6)`` — the
    request-weighted combination of the per-source bad fractions.
    The ``identity`` section re-derives the fleet burn from the
    per-source window counts and checks the equalities exactly (no
    tolerance); a violation means the merge double-counted or dropped
    a record, which is precisely what it is there to catch.

    Returns ``{"kind": "fleet_slo_report", fleet, per_source,
    identity, ...}``; ``ok`` requires the fleet verdict AND the
    identity to hold."""
    specs = list(DEFAULT_SLOS if specs is None else specs)
    records = list(records)
    if now_tick is None:
        now_tick = max((r["retire_tick"] for r in records), default=0)
    sources = sorted({_source_of(r) for r in records})
    fleet = evaluate(records, specs, now_tick=now_tick)
    per_source = {
        s: evaluate([r for r in records if _source_of(r) == s],
                    specs, now_tick=now_tick)
        for s in sources
    }
    checks: List[Dict[str, Any]] = []
    holds = True
    for i, spec in enumerate(specs):
        budget = 1.0 - spec.objective
        for label in ("fast", "slow"):
            fw = fleet["slos"][i]["windows"][label]
            sum_bad = sum(
                per_source[s]["slos"][i]["windows"][label]["bad"]
                for s in sources)
            sum_n = sum(
                per_source[s]["slos"][i]["windows"][label]["requests"]
                for s in sources)
            recombined = (round((sum_bad / sum_n) / budget, 6)
                          if sum_n and budget > 0 else 0.0)
            ok = (fw["bad"] == sum_bad
                  and fw["requests"] == sum_n
                  and fw["burn_rate"] == recombined)
            holds = holds and ok
            checks.append({
                "slo": spec.name, "window": label,
                "fleet_bad": fw["bad"],
                "sum_source_bad": sum_bad,
                "fleet_requests": fw["requests"],
                "sum_source_requests": sum_n,
                "fleet_burn": fw["burn_rate"],
                "recombined_burn": recombined,
                "holds": ok,
            })
    return {
        "v": SCHEMA_VERSION,
        "kind": "fleet_slo_report",
        "now_tick": int(now_tick),
        "sources": sources,
        "fleet": fleet,
        "per_source": per_source,
        "identity": {"holds": holds, "checks": checks},
        "breaches": fleet["breaches"],
        "ok": fleet["ok"] and holds,
    }


__all__ = ["FAST_WINDOW", "SLOW_WINDOW", "BURN_THRESHOLD", "SLOSpec",
           "DEFAULT_SLOS", "parse_specs", "records_from_spans", "evaluate",
           "fleet_evaluate"]
