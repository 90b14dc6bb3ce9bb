"""Pure-Python pipeline tick tables: the one schedule derivation (a
copy of the JAX package's ``parallel/pp_schedule.py``, which the port
may not import).

Pipeline schedules here are lockstep programs: every stage executes the
same sequence of ticks, each tick holding at most one forward sub-slot
and one backward sub-slot of CHUNK-granular work (a chunk = the stage's
``num_blocks/(p*v)`` consecutive blocks; at ``virtual == 1`` the chunk
IS the stage's whole slice).  This module derives, with no torch
import, exactly which (stage, tick) runs which (direction,
virtual-chunk, microbatch), and both of the port's schedules read their
rank's row straight from THIS table: the GPipe / interleaved forward and
its reverse-tick backward (``models/transformer.apply_pipeline``) and
the fused 1F1B family
(``models/transformer.pipeline_value_and_grad_1f1b``); the tests
(``tests/test_torch_pipeline_parallel.py``) hold the copy to JAX's
table, so schedule correctness is checkable without a process group.

Schedule family (``p`` stages, ``v`` virtual chunks per stage, ``m``
microbatches; work units per stage per direction = ``v*m``):

- **forward wavefront** (shared by gpipe and 1f1b): stage ``s`` runs
  its ``ts``-th forward unit at tick ``t = s + ts`` where round
  ``g = ts // p`` and offset ``r = ts % p`` select chunk ``g % v`` of
  microbatch ``(g // v) * p + r`` — groups of p microbatches cycle
  through the v chunks in execution order (Megatron's interleaved
  pattern; at v == 1 it degenerates to GPipe's ``m = t - s``).
- **1f1b backward wavefront**: stage ``s`` runs its ``ts``-th backward
  unit at tick ``t = (p - 1 - s) + ts + delay`` with
  ``delay = p*v - 1``, the reverse traversal: round ``g`` selects
  chunk ``v - 1 - g % v`` of microbatch ``(g // v) * p + r``.  The
  delay is exact: the LAST stage's LAST chunk backwards a microbatch
  in the very tick its forward completed, every hop dependency
  (activations ``s -> s+1``; the chunk wrap ``p-1 -> 0``; gradients
  reversed) lands exactly one tick before its consumer, and at
  ``v == 1`` the tick count collapses to the classic
  ``m + 2(p - 1)`` fused-1F1B schedule.

Tick specialization is what realizes the interleaved bubble shrink in
a lockstep realization: ticks before the first live backward
(``p*v - 1`` of them) are emitted FORWARD-ONLY and the trailing
``p*v - 1`` ticks BACKWARD-ONLY, so warmup/drain cost one sub-slot
each instead of a dead fwd+bwd pair.  In full-stage fwd+bwd work
units the 1f1b family then measures ``(v*m + p - 1)/v`` against the
ideal ``m`` — bubble fraction ``(p-1)/(v*m + p - 1)``, the ~v-fold
shrink over plain 1F1B (Narayanan et al.; GPipe's reverse-tick schedule
measures the same fraction at its own v).

Stash liveness: a forward unit's input must survive until its
backward sub-slot.  ``stash_cap = min(v*m, 2*p*v - 1)`` — at v == 1
the familiar ``min(m, 2p-1)`` — is the RING the 1F1B schedule's
``ts % stash_cap`` slot addressing needs: a chunk-0 unit's backward
sits ``(v-1)*p`` units later in the reverse traversal, so modulo
reuse demands the full ``2pv - 1`` even though peak simultaneous
liveness is only ``min(v*m, p*(v+1) - 1)`` (the two coincide at
v == 1).  Reuse safety — a slot's next write lands strictly after
the evicted unit's backward read — is verified structurally by
``check_table``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SubSlot:
    """One stage's share of a tick's forward or backward sub-slot.

    ``live`` False = this stage idles the sub-slot (the port skips it;
    ``chunk``/``microbatch`` are then placeholder indices, always in
    range).  ``unit`` is
    the unit's FORWARD work-slot index ``ts`` (backward rows carry the
    fwd ``ts`` of the unit they retire, i.e. the stash slot to read =
    ``unit % stash_cap``).  ``head`` marks the loss-bearing unit: last
    stage, last virtual chunk."""

    live: bool
    chunk: int
    microbatch: int
    unit: int
    head: bool


@dataclasses.dataclass(frozen=True)
class TickTable:
    """The full schedule: ``fwd[t]``/``bwd[t]`` are per-stage SubSlot
    rows, or None when NO stage has that direction at tick ``t`` (the
    schedule then omits the sub-slot — the warmup/drain
    specialization)."""

    schedule: str
    n_stages: int
    virtual: int
    microbatches: int
    ticks: int
    stash_cap: int
    fwd: List[Optional[List[SubSlot]]]
    bwd: List[Optional[List[SubSlot]]]

    @property
    def total_units(self) -> int:
        return self.virtual * self.microbatches


def _validate(p: int, v: int, m: int) -> None:
    if p < 1:
        raise ValueError(f"n_stages={p} must be >= 1")
    if v < 1:
        raise ValueError(f"virtual={v} must be >= 1")
    if m < 1:
        raise ValueError(f"microbatches={m} must be >= 1")
    if v > 1 and p < 2:
        raise ValueError(
            f"virtual={v} needs n_stages >= 2 (nothing to interleave "
            f"on one stage)")
    if v > 1 and m % p:
        raise ValueError(
            f"interleaved stages need microbatches ({m}) divisible "
            f"by n_stages ({p})")


def fwd_unit(ts: int, p: int, v: int) -> Tuple[int, int]:
    """Forward work-slot index -> (chunk, microbatch)."""
    g, r = divmod(ts, p)
    return g % v, (g // v) * p + r


def bwd_unit(ts: int, p: int, v: int) -> Tuple[int, int]:
    """Backward work-slot index -> (chunk, microbatch): the reverse
    chunk traversal of the same round structure."""
    g, r = divmod(ts, p)
    return v - 1 - g % v, (g // v) * p + r


def fwd_ts(chunk: int, microbatch: int, p: int, v: int) -> int:
    """Inverse of fwd_unit: the forward work-slot index of a unit."""
    return ((microbatch // p) * v + chunk) * p + microbatch % p


def stash_cap(p: int, v: int, m: int) -> int:
    """Input-stash buffers a stage needs under the 1f1b family:
    ``min(v*m, 2*p*v - 1)`` — M-independent once m is large enough."""
    return min(v * m, 2 * p * v - 1)


def _fwd_rows(p: int, v: int, m: int, ticks: int,
              ) -> List[Optional[List[SubSlot]]]:
    total = v * m
    last = p - 1
    rows: List[Optional[List[SubSlot]]] = []
    for t in range(ticks):
        if not any(0 <= t - s < total for s in range(p)):
            rows.append(None)
            continue
        row = []
        for s in range(p):
            ts = t - s
            if 0 <= ts < total:
                c, mb = fwd_unit(ts, p, v)
                row.append(SubSlot(True, c, mb, ts,
                                   s == last and c == v - 1))
            else:
                row.append(SubSlot(False, 0, 0, 0, False))
        rows.append(row)
    return rows


def gpipe_table(p: int, v: int, m: int) -> TickTable:
    """The GPipe/interleaved forward wavefront (apply_pipeline's tick
    loop; the backward is the same loop's transpose, run tick by tick in
    reverse, so the table carries forward rows only and the cost
    accounting doubles them)."""
    _validate(p, v, m)
    ticks = v * m + p - 1
    return TickTable("gpipe", p, v, m, ticks, v * m,
                     _fwd_rows(p, v, m, ticks), [None] * ticks)


def interleaved_1f1b_table(p: int, v: int, m: int) -> TickTable:
    """The fused-tick 1f1b family: v == 1 is the classic 1F1B
    (m + 2(p-1) ticks), v > 1 the Megatron interleaved refinement
    (v*m + p(v+1) - 2 chunk-granular ticks)."""
    _validate(p, v, m)
    if p < 2:
        raise ValueError(
            f"1f1b needs n_stages >= 2 (no schedule to fuse on one "
            f"stage), got {p}")
    total = v * m
    delay = p * v - 1
    ticks = total + delay + (p - 1)
    cap = stash_cap(p, v, m)
    fwd = _fwd_rows(p, v, m, ticks)
    bwd: List[Optional[List[SubSlot]]] = []
    last = p - 1
    for t in range(ticks):
        if not any(0 <= t - (last - s) - delay < total for s in range(p)):
            bwd.append(None)
            continue
        row = []
        for s in range(p):
            ts = t - (last - s) - delay
            if 0 <= ts < total:
                c, mb = bwd_unit(ts, p, v)
                row.append(SubSlot(True, c, mb, fwd_ts(c, mb, p, v),
                                   s == last and c == v - 1))
            else:
                row.append(SubSlot(False, 0, 0, 0, False))
        bwd.append(row)
    return TickTable("1f1b", p, v, m, ticks, cap, fwd, bwd)


def schedule_table(schedule: str, p: int, v: int, m: int) -> TickTable:
    """``schedule`` in {'gpipe', '1f1b'} (each at any v >= 1; v > 1 is
    the interleaved refinement of either)."""
    if schedule == "gpipe":
        return gpipe_table(p, v, m)
    if schedule == "1f1b":
        return interleaved_1f1b_table(p, v, m)
    raise ValueError(
        f"unknown schedule {schedule!r}: expected 'gpipe' or '1f1b'")


def tick_counts(table: TickTable) -> dict:
    """Raw sub-slot structure: total ticks, fwd-only / bwd-only /
    combined tick counts, and live work units per direction."""
    fwd_only = sum(1 for f, b in zip(table.fwd, table.bwd)
                   if f is not None and b is None)
    bwd_only = sum(1 for f, b in zip(table.fwd, table.bwd)
                   if f is None and b is not None)
    both = sum(1 for f, b in zip(table.fwd, table.bwd)
               if f is not None and b is not None)
    return {"ticks": table.ticks, "fwd_only_ticks": fwd_only,
            "bwd_only_ticks": bwd_only, "combined_ticks": both,
            "units_per_direction": table.total_units}


def bubble_fraction(table: TickTable, fwd_cost: float = 1.0,
                    bwd_cost: float = 2.0) -> dict:
    """Measured vs ideal work-time for the schedule, in full-stage
    forward-cost units (one chunk sub-slot costs ``cost/v``; a gpipe
    table's reverse-tick backward replays every forward tick backward,
    so its ticks each cost ``(fwd+bwd)/v``).  ``ideal`` is the zero-bubble
    bound: m microbatches of full-stage fwd+bwd work per stage.
    ``bubble_fraction = 1 - ideal/measured`` — the fraction of the
    step the hardware idles (or, lockstep, computes masked garbage)."""
    v = table.virtual
    if table.schedule == "gpipe":
        measured = table.ticks * (fwd_cost + bwd_cost) / v
    else:
        measured = sum(
            (fwd_cost if f is not None else 0.0)
            + (bwd_cost if b is not None else 0.0)
            for f, b in zip(table.fwd, table.bwd)) / v
    ideal = table.microbatches * (fwd_cost + bwd_cost)
    return {
        "measured_ticks": round(measured, 4),
        "ideal_ticks": round(ideal, 4),
        "bubble_fraction": round(1.0 - ideal / measured, 4),
        **tick_counts(table),
    }


def check_table(table: TickTable) -> None:
    """Structural invariants — raises AssertionError on any violation.
    The tests call this over a (p, v, m) matrix; the schedules'
    correctness argument leans on exactly these properties:

    1. every (stage, chunk, microbatch) unit appears exactly once
       forward and (1f1b) exactly once backward;
    2. every consumer's producer ran exactly one tick earlier
       (activations ``s-1 -> s``; chunk wrap ``p-1 -> 0``; gradients
       reversed), and a unit's backward never precedes its forward;
    3. stash discipline: live stashed inputs never exceed
       ``stash_cap`` and a slot's rewrite lands strictly after the
       evicted unit's backward read.
    """
    p, v, m = table.n_stages, table.virtual, table.microbatches
    fwd_at = {}
    bwd_at = {}
    for t in range(table.ticks):
        for kind, rows, seen in (("fwd", table.fwd, fwd_at),
                                 ("bwd", table.bwd, bwd_at)):
            row = rows[t]
            if row is None:
                continue
            assert len(row) == p, f"{kind} row width at tick {t}"
            assert any(e.live for e in row), \
                f"tick {t}: emitted {kind} sub-slot with no live stage"
            for s, e in enumerate(row):
                assert 0 <= e.chunk < v and 0 <= e.microbatch < m, \
                    f"tick {t} stage {s}: {kind} indices out of range"
                if not e.live:
                    continue
                key = (s, e.chunk, e.microbatch)
                assert key not in seen, f"duplicate {kind} unit {key}"
                seen[key] = t
                assert e.head == (s == p - 1 and e.chunk == v - 1), \
                    f"tick {t} stage {s}: head flag wrong"
    units = {(s, c, mb) for s in range(p) for c in range(v)
             for mb in range(m)}
    assert set(fwd_at) == units, "forward coverage incomplete"
    if table.schedule == "1f1b":
        assert set(bwd_at) == units, "backward coverage incomplete"
    for (s, c, mb), t in fwd_at.items():
        if s > 0:
            assert fwd_at[(s - 1, c, mb)] == t - 1, \
                f"fwd hop into {(s, c, mb)} not one tick earlier"
        elif c > 0:
            assert fwd_at[(p - 1, c - 1, mb)] == t - 1, \
                f"fwd wrap into {(s, c, mb)} not one tick earlier"
    for (s, c, mb), t in bwd_at.items():
        assert t >= fwd_at[(s, c, mb)], \
            f"backward of {(s, c, mb)} precedes its forward"
        if s < p - 1:
            assert bwd_at[(s + 1, c, mb)] == t - 1, \
                f"grad hop into {(s, c, mb)} not one tick earlier"
        elif c < v - 1:
            assert bwd_at[(0, c + 1, mb)] == t - 1, \
                f"grad wrap into {(s, c, mb)} not one tick earlier"
    if table.schedule != "1f1b":
        return
    cap = table.stash_cap
    for s in range(p):
        slots: dict = {}
        live = 0
        peak = 0
        for t in range(table.ticks):
            frow, brow = table.fwd[t], table.bwd[t]
            if frow is not None and frow[s].live:
                e = frow[s]
                sl = e.unit % cap
                assert sl not in slots, \
                    f"stage {s} tick {t}: slot {sl} rewritten before " \
                    f"its backward read"
                slots[sl] = (e.chunk, e.microbatch)
                live += 1
                peak = max(peak, live)
            if brow is not None and brow[s].live:
                e = brow[s]
                sl = e.unit % cap
                assert slots.get(sl) == (e.chunk, e.microbatch), \
                    f"stage {s} tick {t}: backward reads slot {sl} " \
                    f"holding {slots.get(sl)}, wanted " \
                    f"{(e.chunk, e.microbatch)}"
                del slots[sl]
                live -= 1
        assert not slots, f"stage {s}: units never retired: {slots}"
        assert peak <= cap, f"stage {s}: {peak} live stashes > cap {cap}"
