"""Workload capture: a span directory -> a portable, replayable schedule
(the port's copy of the JAX package's ``obs/workload.py``).

- ``capture(run_dir)`` distills the span streams of one engine run or a
  fleet run (``replica<i>``/``router`` children) into the WORKLOAD
  document of ``obs/schema.py``: per-request arrival offsets, prompt and
  output token counts, relative deadlines, trace ids and the prompt
  fingerprint;
- ``synthetic_workload`` makes a seeded one (Poisson-like arrivals,
  shared-prefix groups);
- ``load_workload`` / ``write_workload`` read and write the plain JSON
  file, validated; ``serving/replay.py`` feeds it back through an
  engine or a fleet.

Fingerprints, not tokens: the span stream never carries prompt content.
The engine hashes each ``FINGERPRINT_BLOCK``-token block of a prompt
chained on the previous block's hash (``prompt_fingerprint``), so two
prompts share a fingerprint prefix exactly when they share a token
prefix; ``synth_prompt`` regenerates a stand-in prompt from the
fingerprint (same hash, same block), so a replay keeps the lengths and
the sharing without storing any prompt.

Arrival offsets come from the submit span's ``arrival`` field (the
engine's monotonic clock, exact within one source), placed across fleet
sources by the collector's skew-aligned wall timestamps; deadlines are
stored relative (ms from arrival), so a replay never inherits the
recording's wall clock.  The hashes, the id and the document are the
JAX package's byte for byte, so a workload written by either package
loads in the other with the same ``workload_id``.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Any, Dict, Iterable, List, Optional

from . import collector as collector_lib
from .schema import SCHEMA_VERSION, validate_workload
from .spans import reconstruct

# prompt tokens per fingerprint block: the default KV page size, so one
# fingerprint entry stands for one shareable page
FINGERPRINT_BLOCK = 16

# hex digits per fingerprint entry (48 bits)
_FP_HEX = 12


def prompt_fingerprint(tokens: Iterable[int],
                       block: int = FINGERPRINT_BLOCK) -> List[str]:
    """Chained per-block prompt hash: entry ``i`` digests block ``i``'s
    tokens and entry ``i-1``, so two fingerprints share a prefix exactly
    when the prompts share a token prefix."""
    toks = [int(t) for t in tokens]
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    out: List[str] = []
    prev = b""
    for i in range(0, len(toks), block):
        h = hashlib.sha1()
        h.update(prev)
        h.update(",".join(str(t) for t in toks[i:i + block]).encode())
        digest = h.hexdigest()[:_FP_HEX]
        out.append(digest)
        prev = digest.encode()
    return out


def synth_prompt(prompt_len: int, fingerprint: Optional[List[str]],
                 vocab_size: int, seed: int = 0,
                 rid: int = 0) -> List[int]:
    """A deterministic stand-in prompt for one workload entry: each
    fingerprint entry seeds its block's tokens, so equal fingerprint
    prefixes give equal token prefixes and two replays submit the same
    prompts.  Without a fingerprint the blocks are keyed on
    ``(seed, rid)``.  Tokens lie in [1, vocab_size)."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len={prompt_len} must be >= 1")
    if vocab_size < 2:
        raise ValueError(f"vocab_size={vocab_size} must be >= 2")
    fps = [str(f) for f in (fingerprint or [])]
    tokens: List[int] = []
    for b in range(0, prompt_len, FINGERPRINT_BLOCK):
        i = b // FINGERPRINT_BLOCK
        if i < len(fps) and fps[i]:
            key = int(fps[i][:_FP_HEX], 16)
        else:
            h = hashlib.sha1(f"{seed}:{rid}:{i}".encode()).hexdigest()
            key = int(h[:_FP_HEX], 16)
        rng = random.Random(key)
        n = min(FINGERPRINT_BLOCK, prompt_len - b)
        tokens.extend(1 + rng.randrange(vocab_size - 1)
                      for _ in range(n))
    return tokens


def workload_id(requests: List[Dict[str, Any]]) -> str:
    """Content hash of the request schedule (arrivals, shapes,
    deadlines, fingerprints; not trace ids or outcomes), so two captures
    of the same traffic get the same id."""
    canon = [[round(float(r["arrival_s"]), 6), int(r["prompt_len"]),
              int(r["max_new_tokens"]),
              (round(float(r["deadline_ms"]), 3)
               if r.get("deadline_ms") is not None else None),
              list(r.get("fingerprint") or [])]
             for r in requests]
    h = hashlib.sha1(json.dumps(canon,
                                separators=(",", ":")).encode())
    return f"wl-{h.hexdigest()[:12]}"


def _finish(requests: List[Dict[str, Any]], source: str,
            t: Optional[float] = None) -> Dict[str, Any]:
    """The validated WORKLOAD document of raw request entries (sorted,
    rids renumbered dense in arrival order, offsets from the first)."""
    requests = sorted(requests,
                      key=lambda r: (float(r["arrival_s"]),
                                     int(r.get("rid", 0))))
    base = min((float(r["arrival_s"]) for r in requests),
               default=0.0)
    for i, r in enumerate(requests):
        r["rid"] = i
        r["arrival_s"] = round(float(r["arrival_s"]) - base, 6)
    doc = {
        "v": SCHEMA_VERSION,
        "kind": "workload",
        "workload_id": workload_id(requests),
        "source": source,
        "generated_t": time.time() if t is None else t,
        "n_requests": len(requests),
        "duration_s": (round(float(requests[-1]["arrival_s"]), 6)
                       if requests else 0.0),
        "requests": requests,
    }
    errs = validate_workload(doc)
    if errs:
        raise ValueError(f"capture produced an invalid workload: "
                         f"{errs[:5]}")
    return doc


def _arrival_offsets(lifecycles, chains) -> Dict[str, Optional[float]]:
    """Per source, the offset that puts its monotonic ``arrival`` values
    on the fleet's axis (its earliest skew-aligned submit time less its
    earliest arrival), or None when a first hop lacks ``arrival`` (the
    source then falls back to its wall submit times)."""
    per_src: Dict[str, List[Dict[str, Any]]] = {}
    for chain in chains.values():
        first = chain[0]
        per_src.setdefault(str(first.get("source") or ""),
                           []).append(first)
    global_t0 = min(r["submit_t"] for r in lifecycles)
    out: Dict[str, Optional[float]] = {}
    for src, firsts in per_src.items():
        if all(r.get("arrival") is not None for r in firsts):
            out[src] = (min(r["submit_t"] for r in firsts) - global_t0
                        - min(float(r["arrival"]) for r in firsts))
        else:
            out[src] = None
    return out


def capture(run_dir: str, align: bool = True) -> Dict[str, Any]:
    """Distill one run dir's span streams into a WORKLOAD document.

    Takes a one-engine run dir or a fleet layout (the collector's
    discovery).  Failover chains join on trace_id: the chain's first hop
    gives the arrival and the prompt shape, its terminal hop the
    outcome, so a failed-over request is one entry.  Shed and router
    narration records are skipped: a workload is the accepted schedule.
    Raises ValueError when the streams hold no replayable request."""
    res = collector_lib.collect([run_dir], align=align)
    recs = reconstruct(res["rows"])
    lifecycles = [r for r in recs.values()
                  if r.get("submit_t") is not None
                  and not r.get("narration")]
    if not lifecycles:
        raise ValueError(f"no accepted request lifecycles under "
                         f"{run_dir!r}")
    # one entry per trace chain (an untraced record is its own chain)
    chains: Dict[Any, List[Dict[str, Any]]] = {}
    for i, r in enumerate(sorted(lifecycles,
                                 key=lambda r: r["submit_t"])):
        key = r.get("trace_id") or ("", r.get("source"), r["proc"],
                                    r["rid"], i)
        chains.setdefault(key, []).append(r)
    src_offset = _arrival_offsets(lifecycles, chains)
    global_t0 = min(r["submit_t"] for r in lifecycles)
    requests: List[Dict[str, Any]] = []
    for chain in chains.values():
        first, last = chain[0], chain[-1]
        terminal = next((r["terminal"] for r in chain
                         if r.get("terminal")
                         and r["terminal"] != "failed"),
                        last.get("terminal"))
        done = next((r for r in reversed(chain)
                     if r.get("generated") is not None), last)
        off = src_offset[str(first.get("source") or "")]
        if off is not None and first.get("arrival") is not None:
            arrival_s = float(first["arrival"]) + off
        else:
            arrival_s = float(first["submit_t"]) - global_t0
        deadline_ms = None
        if first.get("deadline") is not None \
                and first.get("arrival") is not None:
            deadline_ms = max(
                0.0, round((float(first["deadline"])
                            - float(first["arrival"])) * 1e3, 3))
        if not first.get("prompt_len") \
                or not first.get("max_new_tokens"):
            continue
        requests.append({
            "rid": 0,  # renumbered by _finish
            "arrival_s": arrival_s,
            "prompt_len": int(first["prompt_len"]),
            "max_new_tokens": int(first["max_new_tokens"]),
            "output_tokens": (int(done["generated"])
                              if done.get("generated") is not None
                              else None),
            "deadline_ms": deadline_ms,
            "trace_id": first.get("trace_id"),
            "terminal": terminal,
            "fingerprint": list(first.get("fingerprint") or []),
        })
    if not requests:
        raise ValueError(f"no replayable requests under {run_dir!r}")
    return _finish(requests, source=run_dir)


def synthetic_workload(n: int, seed: int = 0, qps: float = 50.0,
                       mean_prompt: int = 24, mean_new: int = 12,
                       vocab_size: int = 64,
                       shared_prefix_frac: float = 0.5,
                       prefix_len: int = FINGERPRINT_BLOCK,
                       deadline_ms: Optional[float] = None
                       ) -> Dict[str, Any]:
    """A seeded synthetic WORKLOAD: exponential inter-arrivals at
    ``qps``, lengths around the means (capped at 4x), and a
    ``shared_prefix_frac`` share of requests opening with the same
    ``prefix_len``-token system prompt."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    rng = random.Random(seed)
    prefix = [1 + rng.randrange(vocab_size - 1)
              for _ in range(prefix_len)]
    t = 0.0
    requests: List[Dict[str, Any]] = []
    for i in range(n):
        t += rng.expovariate(qps)
        p = max(1, min(4 * mean_prompt,
                       int(rng.expovariate(1.0 / mean_prompt)) + 1))
        m = max(1, min(4 * mean_new,
                       int(rng.expovariate(1.0 / mean_new)) + 1))
        if rng.random() < shared_prefix_frac:
            body = [1 + rng.randrange(vocab_size - 1)
                    for _ in range(max(1, p))]
            tokens = prefix + body
        else:
            tokens = [1 + rng.randrange(vocab_size - 1)
                      for _ in range(p)]
        requests.append({
            "rid": i,
            "arrival_s": round(t, 6),
            "prompt_len": len(tokens),
            "max_new_tokens": m,
            "output_tokens": m,
            "deadline_ms": deadline_ms,
            "trace_id": None,
            "terminal": None,
            "fingerprint": prompt_fingerprint(tokens),
        })
    return _finish(requests, source=f"synthetic:seed={seed}", t=0.0)


def load_workload(path: str) -> Dict[str, Any]:
    """Read and validate a workload file; ValueError on a bad one."""
    with open(path) as f:
        doc = json.load(f)
    errs = validate_workload(doc, where=path)
    if errs:
        raise ValueError("; ".join(errs[:5]))
    return doc


def write_workload(doc: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


__all__ = ["FINGERPRINT_BLOCK", "prompt_fingerprint", "synth_prompt",
           "workload_id", "capture", "synthetic_workload",
           "load_workload", "write_workload"]
