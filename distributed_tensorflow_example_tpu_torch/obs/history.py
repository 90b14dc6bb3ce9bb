"""The rolling bench history — the port's copy of the JAX package's
``obs/history.py``.

A pairwise gate compares against one baseline: a slow creep (1% a
round) passes every pairwise gate while losing 10% over ten rounds.
This module is the append-only memory:

- ``append_entry`` reduces any comparison document (bench final
  summary, run report, BENCH capture — ``obs/compare.extract_metrics``
  normalizes) to its gate metrics and appends one strict-JSON record to
  a ``history.jsonl`` (shape: ``obs/schema.HISTORY_ENTRY``);
- ``rolling_baseline`` folds the last N entries into a per-metric
  median baseline (robust to one noisy round) in the
  ``history_baseline`` shape ``obs/compare`` reads;
- ``import_captures`` backfills from BENCH captures, idempotent on the
  label;
- ``trend_table`` renders the ``dtx-obs history`` one-line-per-round
  view.

Pure file I/O over strict JSON.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import compare as cmp_lib
from .schema import SCHEMA_VERSION

# trend-table default columns, in priority order; --metrics overrides
TREND_METRICS = ("wall_s", "mfu", "test_accuracy", "goodput_frac",
                 "serving_p99_ms", "serving_tok_s")


def append_entry(path: str, doc: Dict[str, Any], label: str = "",
                 source: str = "", t: Optional[float] = None) -> Dict[str, Any]:
    """Reduce ``doc`` (any obs/compare shape) to its gate metrics and
    append one history record; returns the record (its metrics may be
    empty — the caller decides whether that is an error)."""
    entry = {
        "v": SCHEMA_VERSION,
        "kind": "bench_history",
        "t": float(time.time() if t is None else t),
        "label": str(label),
        "source": str(source),
        "metrics": cmp_lib.extract_metrics(doc),
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, allow_nan=False) + "\n")
    return entry


def read_history(path: str) -> List[Dict[str, Any]]:
    """Every well-formed history record in the file, in append order.
    Torn or foreign lines are skipped (an append-only log must survive a
    crashed writer); ``dtx-obs validate`` is the strict check."""
    out: List[Dict[str, Any]] = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict) and row.get("kind") == "bench_history":
                out.append(row)
    return out


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def rolling_baseline(entries: Iterable[Dict[str, Any]],
                     n: int) -> Dict[str, Any]:
    """Per-metric median over the last ``n`` entries, as a
    ``history_baseline`` document ``obs/compare.extract_metrics`` reads.
    A metric contributes wherever present, so a round that skipped one
    bench row does not void the baseline."""
    tail = list(entries)[-max(1, int(n)):]
    cols: Dict[str, List[float]] = {}
    for e in tail:
        for name, v in (e.get("metrics") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                cols.setdefault(name, []).append(float(v))
    return {
        "kind": "history_baseline",
        "entries": len(tail),
        "metrics": {name: _median(vals)
                    for name, vals in sorted(cols.items())},
    }


def import_captures(path: str,
                    capture_paths: Iterable[str]) -> Tuple[int, List[str]]:
    """Backfill the history from BENCH captures (or any
    obs/compare-loadable documents).  Idempotent: a capture whose label
    (basename without extension) already appears is skipped.  Returns
    (appended, skipped messages)."""
    have = {e.get("label") for e in read_history(path)}
    appended, skipped = 0, []
    for cap in capture_paths:
        label = os.path.splitext(os.path.basename(cap))[0]
        if label in have:
            skipped.append(f"{cap}: label {label!r} already present")
            continue
        try:
            doc = cmp_lib.load_doc(cap)
        except (OSError, ValueError) as e:
            skipped.append(f"{cap}: unreadable ({e})")
            continue
        metrics = cmp_lib.extract_metrics(doc)
        if not metrics:
            skipped.append(f"{cap}: no gate metrics extractable")
            continue
        # the capture's own mtime keeps the trend in recorded order
        try:
            t = os.path.getmtime(cap)
        except OSError:
            t = None
        append_entry(path, doc, label=label, source="import", t=t)
        have.add(label)
        appended += 1
    return appended, skipped


def trend_table(entries: List[Dict[str, Any]],
                metrics: Optional[Iterable[str]] = None,
                last: int = 0) -> str:
    """One line per history entry (label, in append order) with the
    selected metric columns — the ``dtx-obs history`` view."""
    if last:
        entries = entries[-last:]
    if metrics is None:
        present = set()
        for e in entries:
            present |= set(e.get("metrics") or {})
        metrics = [m for m in TREND_METRICS if m in present] or \
            sorted(present)[:len(TREND_METRICS)]
    metrics = list(metrics)
    wl = max([len("label")] + [len(str(e.get("label"))) for e in entries])

    def fmt(v) -> str:
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    head = "label".ljust(wl) + "  " + "  ".join(
        m.rjust(max(len(m), 8)) for m in metrics)
    lines = [head]
    for e in entries:
        m = e.get("metrics") or {}
        lines.append(
            str(e.get("label")).ljust(wl) + "  " + "  ".join(
                fmt(m.get(name)).rjust(max(len(name), 8))
                for name in metrics))
    return "\n".join(lines)
