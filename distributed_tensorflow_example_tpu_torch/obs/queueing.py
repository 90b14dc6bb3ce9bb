"""Fleet queueing analytics over the span stream — the port's copy of
the JAX package's ``obs/queueing.py``.

The waterfall (``obs/waterfall.py``) explains one request; this module
explains the queue: arrival rate, per-prompt-bucket service time,
decode utilization, and a Little's-law check.  The law (L = lambda * W)
is an accounting identity over a window where every arrival also
terminates, so a relative error beyond tolerance is evidence of
untracked time (requests whose terminal never reached the stream);
``violations`` counts the in-flight or torn requests that explain a
gap.  ``queueing_report()`` feeds the fleet report's ``queueing``
section (``obs/collector.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# a request is "in system" from submit to its typed terminal
_TERMINALS = ("retire", "timeout", "shed", "failed", "error")


def queueing_report(rows: List[dict],
                    tolerance: float = 0.05) -> Optional[dict]:
    """Queueing analytics over a span stream (one proc's file or a
    collector-merged fleet stream); None when the stream carries no
    submits to measure."""
    submits: Dict[Tuple[int, int], float] = {}
    terminals: Dict[Tuple[int, int], float] = {}
    admits: Dict[Tuple[int, int], float] = {}
    bucket_of: Dict[Tuple[int, int], int] = {}
    occupancies: List[float] = []
    for row in rows:
        ev = row.get("event")
        proc = row.get("proc")
        rid = row.get("rid")
        t = row.get("t")
        if ev == "tick" and isinstance(row.get("occupancy"),
                                       (int, float)):
            occupancies.append(float(row["occupancy"]))
            continue
        if not (isinstance(proc, int) and isinstance(rid, int)
                and isinstance(t, (int, float))):
            continue
        key = (proc, rid)
        if ev == "submit":
            submits.setdefault(key, t)
        elif ev == "admit":
            admits.setdefault(key, t)
        elif ev == "prefill" and isinstance(row.get("bucket"), int):
            bucket_of.setdefault(key, row["bucket"])
        elif ev in _TERMINALS:
            terminals.setdefault(key, t)
    if not submits:
        return None

    t_lo = min(submits.values())
    t_hi = max(list(terminals.values()) + list(submits.values()))
    window_s = max(t_hi - t_lo, 1e-9)
    arrivals = len(submits)
    completed = [k for k in submits if k in terminals]
    in_flight = [k for k in submits if k not in terminals]

    # per-prompt-bucket service time: admit -> terminal (the time the
    # request actually held engine resources)
    per_bucket: Dict[str, List[float]] = {}
    for k in completed:
        if k in admits:
            ms = (terminals[k] - admits[k]) * 1e3
            per_bucket.setdefault(str(bucket_of.get(k, 0)),
                                  []).append(ms)
    service = {
        b: {"n": len(v),
            "mean_ms": round(sum(v) / len(v), 3),
            "max_ms": round(max(v), 3)}
        for b, v in sorted(per_bucket.items())
    }

    # Little's law as an identity: L from the integral of the
    # in-system count (= sum of in-window sojourns / window), lambda
    # from arrivals, W from the completed sojourns.  Exact when every
    # arrival terminates in-window; in-flight/torn requests are the
    # violations that explain any gap.
    sojourn_total = sum(
        (terminals.get(k, t_hi) - submits[k]) for k in submits)
    big_l = sojourn_total / window_s
    lam = arrivals / window_s
    w_s = (sum(terminals[k] - submits[k] for k in completed)
           / len(completed)) if completed else 0.0
    lam_w = lam * w_s
    rel_err = (abs(big_l - lam_w) / big_l) if big_l > 0 else 0.0
    return {
        "window_s": round(window_s, 6),
        "arrivals": arrivals,
        "arrival_rate_per_s": round(lam, 4),
        "completed": len(completed),
        "in_flight": len(in_flight),
        "utilization": (round(sum(occupancies) / len(occupancies), 4)
                        if occupancies else None),
        "service_ms_by_bucket": service,
        "littles_law": {
            "L": round(big_l, 6),
            "lambda_per_s": round(lam, 6),
            "W_ms": round(w_s * 1e3, 3),
            "lambda_W": round(lam_w, 6),
            "rel_err": round(rel_err, 6),
            "holds": rel_err <= tolerance,
            "violations": len(in_flight),
        },
    }
