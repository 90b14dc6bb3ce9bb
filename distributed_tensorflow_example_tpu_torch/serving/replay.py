"""Open-loop replay of a captured workload (the port's copy of the JAX
package's ``serving/replay.py``).

``obs/workload.py`` distills a span directory into a WORKLOAD document;
this module feeds the document back through the serving stack at the
recorded (or ``speed``-scaled) arrival offsets, so a traffic shape
becomes a reproducible benchmark.  Two paths share one schedule:

- ``replay_sim``: the schedule through the port's own
  ``ContinuousScheduler`` and ``simulate`` on the ticks-as-seconds clock
  (one tick a workload second at speed 1), so arrival offsets and
  relative deadlines round-trip through capture unchanged.  Pure Python,
  no clock: the same workload and pool give the same report;
- ``replay_engine``: an open-loop driver over a running ``DecodeEngine``
  or a ``Router`` fleet (anything with ``submit``/``result``).  Prompts
  are regenerated from the fingerprints (``obs/workload.synth_prompt``),
  submits fire at ``arrival_s / speed`` on an injectable clock (tests
  pass a virtual one whose ``sleep`` advances it), and relative
  deadlines scale with the speed.  With greedy decoding two replays of
  one workload give the same typed terminals and tokens, which
  ``identity()`` checks.

``replay_recorder`` builds a ``SpanRecorder`` that stamps every row with
``replay_of: <workload_id>``, so a replay's stream names its workload.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import spans as spans_lib
from ..obs.workload import synth_prompt
from . import scheduler as sched_lib
from .admission import ShedError

# how long ``replay_engine`` waits on each result after the last submit
# before it calls the request wedged
RESULT_TIMEOUT_S = 120.0

# the open-loop wait's polling slice (a real clock; a virtual clock's
# sleep() advances time instead)
_WAIT_SLICE_S = 0.02


def replay_recorder(logs_path: str, workload_id: str,
                    process_index: int = 0,
                    **kw) -> spans_lib.SpanRecorder:
    """A ``SpanRecorder`` whose every row carries ``replay_of``: give it
    to the engine or the router under replay."""
    return spans_lib.SpanRecorder(
        logs_path, process_index=process_index,
        extra={"replay_of": str(workload_id)}, **kw)


def _schedule(doc: Dict[str, Any], speed: float) -> List[Dict[str, Any]]:
    if speed <= 0:
        raise ValueError(f"speed={speed} must be > 0")
    return sorted(doc["requests"], key=lambda r: (float(r["arrival_s"]),
                                                  int(r["rid"])))


def _sim_requests(doc: Dict[str, Any], speed: float) -> List[tuple]:
    """The ``scheduler.submit`` argument tuples of the schedule: arrival
    tick ``arrival_s / speed``, a relative deadline made absolute the
    same way, and the recorded fingerprint as the trailing keyword slot
    when there is one (the submit spans then carry it verbatim)."""
    out = []
    for r in _schedule(doc, speed):
        arrival = float(r["arrival_s"]) / speed
        req = (int(r["rid"]), int(r["prompt_len"]),
               int(r["max_new_tokens"]), arrival)
        deadline = None
        if r.get("deadline_ms") is not None:
            deadline = arrival + float(r["deadline_ms"]) / 1e3 / speed
        fp = r.get("fingerprint") or None
        if fp:
            req += (deadline, None, None, fp)
        elif deadline is not None:
            req += (deadline,)
        out.append(req)
    return out


def replay_sim(doc: Dict[str, Any], num_pages: int = 65,
               page_size: int = 16, max_batch: int = 8,
               speed: float = 1.0,
               recorder=None) -> Dict[str, Any]:
    """The workload's schedule through ``ContinuousScheduler`` and
    ``simulate`` on the ticks-as-seconds clock.  Same workload and pool
    shape, same report; with a recorder the span stream re-captures to
    the same workload."""
    sched = sched_lib.ContinuousScheduler(
        num_pages=num_pages, page_size=page_size, max_batch=max_batch,
        recorder=recorder)
    sim = sched_lib.simulate(sched, _sim_requests(doc, speed))
    per_request = []
    terminals: Dict[str, int] = {}
    for r in doc["requests"]:
        rid = int(r["rid"])
        if rid in sim.finish_ticks:
            term, toks = "result", int(r["max_new_tokens"])
        else:
            term, toks = "timeout", None
        terminals[term] = terminals.get(term, 0) + 1
        per_request.append({"rid": rid, "terminal": term,
                            "tokens": toks, "token_sig": None,
                            "latency": sim.latency_ticks.get(rid)})
    return {
        "kind": "replay_report",
        "mode": "sim",
        "workload_id": doc["workload_id"],
        "speed": float(speed),
        "n_requests": int(doc["n_requests"]),
        "terminals": terminals,
        "completed": terminals.get("result", 0),
        "decode_ticks": sim.decode_ticks,
        "total_ticks": sim.total_ticks,
        "occupancy": round(sim.occupancy, 6),
        "shapes": [list(s) for s in sim.shapes],
        "per_request": per_request,
    }


def _submit(target, prompt: List[int], max_new: int,
            temperature: float, deadline_ms: Optional[float],
            fingerprint: Optional[List[str]]) -> int:
    """Submit to an engine or a router: an engine takes the recorded
    fingerprint; a router does not (its replicas' engines derive one
    from the regenerated prompt)."""
    kw: Dict[str, Any] = {"temperature": temperature}
    if deadline_ms is not None:
        kw["deadline_ms"] = deadline_ms
    try:
        return target.submit(prompt, max_new, fingerprint=fingerprint,
                             **kw)
    except TypeError:
        return target.submit(prompt, max_new, **kw)


def _token_sig(tokens: List[int]) -> str:
    return hashlib.sha1(",".join(str(t) for t in tokens)
                        .encode()).hexdigest()[:16]


def replay_engine(target, doc: Dict[str, Any], vocab_size: int,
                  speed: float = 1.0, temperature: float = 0.0,
                  seed: int = 0,
                  clock: Callable[[], float] = time.monotonic,
                  sleep: Callable[[float], None] = time.sleep,
                  result_timeout_s: float = RESULT_TIMEOUT_S
                  ) -> Dict[str, Any]:
    """Open-loop replay through a running engine or router ``target``:
    submits fire at ``arrival_s / speed`` on ``clock``, deadlines scale
    by ``1 / speed``.  Returns the replay report: the typed-terminal
    multiset, each request's token count and content signature, and the
    wall and throughput accounting."""
    entries = _schedule(doc, speed)
    start = clock()
    rids: Dict[int, int] = {}
    shed: Dict[int, str] = {}
    for r in entries:
        due = float(r["arrival_s"]) / speed
        while True:
            now = clock() - start
            if now >= due:
                break
            sleep(min(due - now, _WAIT_SLICE_S))
        prompt = synth_prompt(int(r["prompt_len"]),
                              r.get("fingerprint"), vocab_size,
                              seed=seed, rid=int(r["rid"]))
        deadline_ms = (float(r["deadline_ms"]) / speed
                       if r.get("deadline_ms") is not None else None)
        try:
            rids[int(r["rid"])] = _submit(
                target, prompt, int(r["max_new_tokens"]), temperature,
                deadline_ms, r.get("fingerprint") or None)
        except ShedError as e:
            shed[int(r["rid"])] = str(e)
    per_request = []
    terminals: Dict[str, int] = {}
    tokens_total = 0
    for r in doc["requests"]:
        rid = int(r["rid"])
        entry = {"rid": rid, "terminal": "shed", "tokens": None,
                 "token_sig": None}
        if rid not in shed:
            res = target.result(rids[rid], timeout=result_timeout_s)
            if res is None:
                entry["terminal"] = "wedged"
            else:
                entry["terminal"] = {
                    "result": "result", "timeout": "timeout",
                    "shed": "shed"}.get(res.get("status"), "failed")
                toks = res.get("tokens")
                if toks is not None:
                    entry["tokens"] = len(toks)
                    entry["token_sig"] = _token_sig(toks)
                    tokens_total += len(toks)
        terminals[entry["terminal"]] = \
            terminals.get(entry["terminal"], 0) + 1
        per_request.append(entry)
    wall_s = max(clock() - start, 1e-9)
    dur = max(float(doc.get("duration_s") or 0.0) / speed, 1e-9)
    return {
        "kind": "replay_report",
        "mode": "engine",
        "workload_id": doc["workload_id"],
        "speed": float(speed),
        "n_requests": int(doc["n_requests"]),
        "terminals": terminals,
        "completed": terminals.get("result", 0),
        "tokens_total": tokens_total,
        "wall_s": round(wall_s, 6),
        "qps_offered": round(doc["n_requests"] / dur, 6),
        "qps_completed": round(terminals.get("result", 0) / wall_s, 6),
        "per_request": per_request,
    }


def identity(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """The determinism verdict over two replay reports of one workload:
    each request's typed terminal, token count and token signature must
    match pairwise (``determinism_frac`` is the matching share), and
    ``identical`` also needs equal terminal multisets."""
    if a.get("workload_id") != b.get("workload_id"):
        raise ValueError(
            f"replay reports of different workloads: "
            f"{a.get('workload_id')} vs {b.get('workload_id')}")
    pa = {r["rid"]: r for r in a.get("per_request", [])}
    pb = {r["rid"]: r for r in b.get("per_request", [])}
    rids = sorted(set(pa) | set(pb))
    mismatches = []
    matched = 0
    for rid in rids:
        ra, rb = pa.get(rid), pb.get(rid)
        if (ra is not None and rb is not None
                and ra["terminal"] == rb["terminal"]
                and ra.get("tokens") == rb.get("tokens")
                and ra.get("token_sig") == rb.get("token_sig")):
            matched += 1
        else:
            mismatches.append({"rid": rid, "a": ra, "b": rb})
    frac = matched / max(len(rids), 1)
    return {
        "identical": (not mismatches
                      and a.get("terminals") == b.get("terminals")),
        "determinism_frac": round(frac, 6),
        "n_requests": len(rids),
        "mismatches": mismatches[:10],
    }


__all__ = ["RESULT_TIMEOUT_S", "replay_recorder", "replay_sim",
           "replay_engine", "identity"]
