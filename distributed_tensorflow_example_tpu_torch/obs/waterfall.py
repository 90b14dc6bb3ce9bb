"""Per-request latency waterfalls from the span stream — the port's copy
of the JAX package's ``obs/waterfall.py``.

A request's submit->terminal wall is partitioned into disjoint segments
(``obs/buckets.WATERFALL_SEGMENTS``) that sum to the wall by
construction: the segments are the gaps between consecutive lifecycle
boundaries, each labeled by the state the request was in when the gap
opened, so they tile the interval; ``residual_ms`` stays ~0.

- ``submit`` opens ``queue_wait``; a ``blocked`` row re-labels the wait
  by its reason (``brownout`` -> ``brownout_clamp_delay``), except while
  the request is in post-restart ``requeue``.
- ``admit`` opens ``prefill``, ``first_token`` opens ``decode_active``.
- Decode time splits on the tick boundary pair: the scheduler's
  ``tick`` row opens it, the engine's ``tick_done`` closes it with the
  execution-only ``dur_ms``; the execution window [done_t - dur,
  done_t] is ``decode_active`` and the rest between member ticks
  ``decode_stall``.
- ``requeue`` / a member ``engine_restart`` opens ``requeue`` until the
  next ``admit``.
- The typed terminal closes the waterfall; a trailing post-execution
  stall re-labels to ``finalize`` (the retire lands at the next
  scheduler boundary, so the gap is bookkeeping, not decode).

``waterfalls()`` derives one document per request, ``summarize()`` the
aggregate (per-segment p50/p99 and the sum-to-wall verdict) that the
serving CLI's ``/explain`` endpoint returns.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .buckets import WATERFALL_SEGMENTS
from .schema import SCHEMA_VERSION

# lifecycle events that carry a single "rid" payload
_OWN_EVENTS = ("submit", "blocked", "admit", "prefill", "first_token",
               "retire", "error", "timeout", "shed", "requeue",
               "failed")

_TERMINAL_NAME = {"retire": "result", "timeout": "timeout",
                  "shed": "shed", "failed": "failed",
                  "error": "failed"}

# tie-break priorities mirroring real emission order at one boundary:
# blocked/admit narration, then the tick row, then execution
# (exec_start < prefill < first_token < exec_end), then supervision,
# then the terminal (retires land at the NEXT boundary, strictly
# after that tick's narration)
_PRIO = {"submit": 0, "blocked": 1, "admit": 2, "tick": 3,
         "exec_start": 4, "prefill": 5, "first_token": 6,
         "exec_end": 7, "engine_restart": 8, "requeue": 9,
         "terminal": 10}


def _tick_table(rows: List[dict]) -> Dict[Tuple[int, int], dict]:
    """(proc, tick) -> {"t", "done_t", "dur_s"}: the scheduler's tick
    row joined with the engine's tick_done close.  Tick indices stay
    monotonic across supervised restarts (serving/engine._recover
    rebuilds the scheduler at the old count), so the key is unique."""
    table: Dict[Tuple[int, int], dict] = {}
    for row in rows:
        ev = row.get("event")
        if ev not in ("tick", "tick_done"):
            continue
        proc = row.get("proc")
        tick = row.get("tick")
        if not isinstance(proc, int) or not isinstance(tick, int):
            continue
        ent = table.setdefault((proc, tick), {})
        if ev == "tick":
            ent["t"] = row["t"]
            ent["rids"] = tuple(row.get("rids") or ())
        else:
            ent["done_t"] = row["t"]
            ent["dur_s"] = float(row.get("dur_ms") or 0.0) / 1e3
    return table


def _boundaries(own: List[dict], ticks: List[Tuple[float, dict]],
                restarts: List[dict]) -> List[Tuple[float, int, str, dict]]:
    """Every labeled time boundary of one request, sorted by (t,
    emission priority): its own lifecycle rows, its member tick
    boundaries (with the synthetic exec_start/exec_end pair when the
    tick carries a tick_done close), and member engine restarts."""
    out: List[Tuple[float, int, str, dict]] = []
    for row in own:
        ev = row["event"]
        kind = "terminal" if ev in _TERMINAL_NAME else ev
        out.append((row["t"], _PRIO.get(kind, 5), kind, row))
    for t, ent in ticks:
        out.append((t, _PRIO["tick"], "tick", ent))
        done_t = ent.get("done_t")
        if done_t is not None:
            # the execution window: dur_ms is execution-only wall, so
            # it ends at done_t and starts dur before it — clamped to
            # the tick row (wall t's vs a monotonic duration can
            # disagree by clock granularity)
            start = max(t, done_t - ent.get("dur_s", 0.0))
            out.append((start, _PRIO["exec_start"], "exec_start", ent))
            out.append((done_t, _PRIO["exec_end"], "exec_end", ent))
    for row in restarts:
        out.append((row["t"], _PRIO["engine_restart"], "engine_restart",
                    row))
    out.sort(key=lambda b: (b[0], b[1]))
    return out


def _one(proc: int, rid: int, own: List[dict],
         ticks: List[Tuple[float, dict]],
         restarts: List[dict]) -> Optional[dict]:
    """The waterfall document for one request, or None when the
    stream holds nothing usable for it."""
    if not own:
        return None
    bounds = _boundaries(own, ticks, restarts)
    submit_t = bounds[0][0]
    terminal = None
    terminal_t = bounds[-1][0]
    for t, _p, kind, row in bounds:
        if kind == "terminal":
            terminal = _TERMINAL_NAME[row["event"]]
            terminal_t = t
            break
    complete = terminal is not None
    trace_id = next((r["trace_id"] for r in own
                     if isinstance(r.get("trace_id"), str)), None)

    # walk the boundaries, labeling each gap with the state entered
    # at its start — the gaps tile [submit_t, terminal_t] exactly
    intervals: List[Tuple[float, float, str]] = []
    state = "untracked"
    stall_via_exec = False
    cur_t = submit_t
    decode_ticks = 0
    requeues = 0

    def close(t: float, next_state: str) -> None:
        nonlocal cur_t, state
        t = min(max(t, cur_t), terminal_t)
        if t > cur_t:
            intervals.append((cur_t, t, state))
        cur_t = max(cur_t, t)
        state = next_state

    for t, _p, kind, row in bounds:
        if t > terminal_t:
            break
        if kind == "submit":
            close(t, "queue_wait")
        elif kind == "blocked":
            if state == "requeue":
                continue  # post-restart waiting IS restart overhead
            seg = ("brownout_clamp_delay"
                   if row.get("reason") == "brownout" else "queue_wait")
            close(t, seg)
        elif kind == "admit":
            close(t, "prefill")
        elif kind == "first_token":
            close(t, "decode_active")
            stall_via_exec = False
        elif kind == "tick":
            decode_ticks += 1
            # only a tick with a tick_done close can separate stall
            # from execution; without one (older stream, crash tick)
            # the state is left alone and the restart/terminal decides
            if row.get("done_t") is not None and state in (
                    "decode_active", "decode_stall"):
                close(t, "decode_stall")
                stall_via_exec = False
        elif kind == "exec_start":
            if state in ("decode_active", "decode_stall"):
                close(t, "decode_active")
        elif kind == "exec_end":
            if state == "decode_active":
                close(t, "decode_stall")
                stall_via_exec = True
        elif kind in ("engine_restart", "requeue"):
            if kind == "requeue":
                requeues += 1
            close(t, "requeue")
        elif kind == "terminal":
            # a trailing post-execution stall is retire/timeout
            # bookkeeping at the next scheduler boundary, not decode
            if state == "decode_stall" and stall_via_exec:
                state = "finalize"
            close(t, "done")
            break
    if not complete and cur_t < terminal_t:
        close(terminal_t, "done")

    segs = {name: 0.0 for name in WATERFALL_SEGMENTS}
    for t0, t1, seg in intervals:
        segs[seg] += t1 - t0
    wall_s = terminal_t - submit_t
    sum_s = sum(segs.values())
    doc = {
        "v": SCHEMA_VERSION,
        "kind": "waterfall",
        "proc": proc,
        "rid": rid,
        "terminal": terminal,
        "submit_t": submit_t,
        "terminal_t": terminal_t,
        "wall_ms": round(wall_s * 1e3, 3),
        "segments": {k: round(v * 1e3, 3) for k, v in segs.items()},
        "segment_sum_ms": round(sum_s * 1e3, 3),
        "residual_ms": round((wall_s - sum_s) * 1e3, 6),
        "decode_ticks": decode_ticks,
        "requeues": requeues,
        "complete": complete,
        "intervals": [[t0, t1, seg] for t0, t1, seg in intervals],
    }
    if trace_id is not None:
        doc["trace_id"] = trace_id
    return doc


def waterfalls(rows: List[dict], rid: Optional[int] = None,
               trace_id: Optional[str] = None,
               proc: Optional[int] = None) -> List[dict]:
    """Derive the per-request waterfall documents from a span stream
    (any order; one proc's file or a merged multi-process stream),
    optionally filtered to one rid / trace id / proc."""
    table = _tick_table(rows)
    own: Dict[Tuple[int, int], List[dict]] = {}
    for row in rows:
        if row.get("event") in _OWN_EVENTS and isinstance(
                row.get("rid"), int) and isinstance(row.get("proc"), int):
            own.setdefault((row["proc"], row["rid"]), []).append(row)
    member_ticks: Dict[Tuple[int, int], List[Tuple[float, dict]]] = {}
    for (p, _tick), ent in sorted(table.items()):
        if "t" not in ent:
            continue  # tick_done without its tick row (torn tail)
        for r in ent.get("rids", ()):
            if isinstance(r, int):
                member_ticks.setdefault((p, r), []).append(
                    (ent["t"], ent))
    restarts: Dict[Tuple[int, int], List[dict]] = {}
    for row in rows:
        if row.get("event") != "engine_restart":
            continue
        p = row.get("proc")
        for r in (row.get("rids") or ()):
            if isinstance(r, int) and isinstance(p, int):
                restarts.setdefault((p, r), []).append(row)

    out: List[dict] = []
    for (p, r), events in sorted(own.items()):
        if rid is not None and r != rid:
            continue
        if proc is not None and p != proc:
            continue
        doc = _one(p, r, sorted(events, key=lambda e: e["t"]),
                   member_ticks.get((p, r), []),
                   restarts.get((p, r), []))
        if doc is None:
            continue
        if trace_id is not None and doc.get("trace_id") != trace_id:
            continue
        out.append(doc)
    return out


def _pct(vals: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[i]


def summarize(docs: List[dict]) -> dict:
    """Aggregate a set of waterfalls: per-segment p50/p99/mean, the
    wall percentiles, and the sum-to-wall verdict (every complete
    waterfall's residual within 1% of its wall)."""
    complete = [d for d in docs if d.get("complete")]
    terminals: Dict[str, int] = {}
    for d in complete:
        terminals[d["terminal"]] = terminals.get(d["terminal"], 0) + 1
    seg_stats = {}
    for name in WATERFALL_SEGMENTS:
        vals = [d["segments"].get(name, 0.0) for d in complete]
        seg_stats[name] = {
            "p50_ms": round(_pct(vals, 50), 3),
            "p99_ms": round(_pct(vals, 99), 3),
            "mean_ms": round(sum(vals) / len(vals), 3) if vals else 0.0,
        }
    fracs = [d["segment_sum_ms"] / d["wall_ms"]
             for d in complete if d["wall_ms"] > 0]
    resid = [abs(d["residual_ms"]) / d["wall_ms"]
             for d in complete if d["wall_ms"] > 0]
    walls = [d["wall_ms"] for d in complete]
    max_resid = max(resid) if resid else 0.0
    return {
        "requests": len(docs),
        "complete": len(complete),
        "terminals": terminals,
        "wall_p50_ms": round(_pct(walls, 50), 3),
        "wall_p99_ms": round(_pct(walls, 99), 3),
        "segments": seg_stats,
        "min_sum_to_wall_frac": round(min(fracs), 6) if fracs else 1.0,
        "max_residual_frac": round(max_resid, 6),
        "sum_to_wall_ok": max_resid <= 0.01,
    }


__all__ = ["waterfalls", "summarize"]
