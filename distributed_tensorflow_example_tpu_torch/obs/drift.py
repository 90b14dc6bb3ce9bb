"""Model-vs-measured drift detection over the bench history — the port's
copy of the JAX package's ``obs/drift.py``.

The rolling gate answers "is THIS run worse than the recent median?";
this module answers "WHEN did the trajectory move, and which round
moved it?".  It runs change-point detection over a ``history.jsonl``
window: for every metric, every split point's pre/post medians are
compared and the split with the largest shift in the metric's
regression direction (``obs/compare.GATE_METRICS`` knows which way is
worse) wins; a confirmed drift names the metric, the window, the split
and the FIRST offending row label, which is what a bisect needs.
Medians on both sides make one noisy round invisible: a confirmed
drift is a level shift, not a spike.

The roofline join (``--capture``) sets a capture's measured decode
throughput beside the card's HBM peak (``obs/flops.chip_peak_hbm_bytes``,
read from the card of the machine that runs it).  Where the peak is
unknown (the CPU, an unnamed card) the join says so and never confirms
a drift by itself.

``dtx-obs drift HISTORY`` prints the DRIFT_REPORT document and exits 3
on confirmed drift, 0 clean, 2 on unusable input.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from . import history as hist_lib
from .compare import GATE_METRICS
from .schema import SCHEMA_VERSION

# a change-point needs >= 2 entries on each side of the split
MIN_ENTRIES = 4

# default tolerance floor: twice the metric's gate threshold (a drift
# is a sustained move, so it must clear the per-run gate band), never
# below 5% (medians of short benches wobble)
TOL_FLOOR = 0.05


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _tolerance(metric: str, override: Optional[float]) -> float:
    if override is not None:
        return override
    thr = GATE_METRICS.get(metric, (None, 0.0))[1]
    return max(2.0 * thr, TOL_FLOOR)


def detect(labels: List[str], values: List[float], metric: str,
           tolerance: Optional[float] = None) -> Optional[dict]:
    """Change-point detection on one metric's series: the split whose
    pre/post medians shift most in the metric's regression direction;
    a shift beyond tolerance is a confirmed drift naming the first
    offending row.  None = no confirmed drift."""
    n = len(values)
    if n < MIN_ENTRIES:
        return None
    direction = GATE_METRICS.get(metric, ("any",))[0]
    tol = _tolerance(metric, tolerance)
    best = None  # (score, split, pre_med, post_med)
    for k in range(2, n - 1):
        pre = _median(values[:k])
        post = _median(values[k:])
        if pre == 0:
            continue
        shift = (post - pre) / abs(pre)
        # score only the regression direction: "lower"-is-better
        # metrics drift up, "higher"-is-better drift down; metrics
        # without a gate direction drift either way
        if direction == "lower":
            score = shift
        elif direction == "higher":
            score = -shift
        else:
            score = abs(shift)
        if score > (best[0] if best else 0.0):
            best = (score, k, pre, post)
    if best is None or best[0] <= tol:
        return None
    score, k, pre, post = best
    # the first row at/after the split already beyond the pre-median by
    # the tolerance, in the regression direction (the split itself is
    # the fallback)
    first = k
    for i in range(k, n):
        v = values[i]
        if direction == "lower" and v > pre * (1.0 + tol):
            first = i
            break
        if direction == "higher" and v < pre * (1.0 - tol):
            first = i
            break
        if direction not in ("lower", "higher") \
                and abs(v - pre) / abs(pre) > tol:
            first = i
            break
    return {
        "metric": metric,
        "direction": direction,
        "n": n,
        "split": k,
        "pre_median": round(pre, 6),
        "post_median": round(post, 6),
        "shift_frac": round((post - pre) / abs(pre), 6),
        "tolerance": round(tol, 6),
        "first_offending": labels[first],
        "first_offending_index": first,
        "first_offending_value": values[first],
    }


def _roofline(capture_path: str) -> dict:
    """Join a capture's measured decode throughput against the card's
    HBM peak.  Where the peak is unknown the join reports what it
    measured and says so, instead of making up a fraction."""
    from . import compare as cmp_lib
    from . import flops as flops_lib

    doc = cmp_lib.load_doc(capture_path)
    metrics = cmp_lib.extract_metrics(doc)
    peak = flops_lib.chip_peak_hbm_bytes()
    out: dict = {
        "capture": capture_path,
        "decode_hbm_frac": metrics.get("decode_hbm_frac"),
        "chip_peak_hbm_gbps": (round(peak / 1e9, 1)
                               if peak is not None else None),
    }
    if peak is None:
        out["note"] = ("chip HBM peak unknown on this backend — "
                       "informational only; the decode_hbm_frac "
                       "history trajectory is the gated signal")
    return out


def drift_report(history_path: str, window: int = 0,
                 tolerance: Optional[float] = None,
                 metrics: Optional[List[str]] = None,
                 capture: Optional[str] = None) -> dict:
    """The DRIFT_REPORT document: change-point detection over the last
    ``window`` history entries (0 = all) for every numeric metric
    present in >= MIN_ENTRIES of them (or the explicit ``metrics``
    list), plus the optional roofline join."""
    entries = hist_lib.read_history(history_path)
    if window > 0:
        entries = entries[-window:]
    labels = [str(e.get("label")) for e in entries]
    series: Dict[str, List[tuple]] = {}
    for i, e in enumerate(entries):
        for name, v in (e.get("metrics") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series.setdefault(name, []).append((i, float(v)))
    names = (metrics if metrics
             else sorted(n for n, s in series.items()
                         if len(s) >= MIN_ENTRIES))
    drifts = []
    for name in names:
        pts = series.get(name) or []
        if len(pts) < MIN_ENTRIES:
            continue
        d = detect([labels[i] for i, _v in pts],
                   [v for _i, v in pts], name, tolerance)
        if d is not None:
            drifts.append(d)
    return {
        "v": SCHEMA_VERSION,
        "kind": "drift_report",
        "generated_t": time.time(),
        "history_path": history_path,
        "entries": len(entries),
        "window": window,
        "metrics": names,
        "drifts": drifts,
        "roofline": _roofline(capture) if capture else None,
        "ok": not drifts,
    }
