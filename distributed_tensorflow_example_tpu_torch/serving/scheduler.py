"""Continuous-batching scheduler — pure Python, no torch import.

The port's own copy of the JAX package's ``serving/scheduler.py``
(the port imports nothing of that package).  The control plane is
derived entirely off the device: tick by tick the scheduler decides
WHICH ragged requests occupy the shared decode batch and which pages
they own; the engine (serving/engine.py) executes the resulting
``TickPlan`` at one of a finite set of shapes.

Semantics:

- **admission** (FIFO, arrival-gated): a waiting request joins the
  live batch when a slot inside the largest batch bucket AND its full
  conservative page reservation (``ceil((prompt+max_new-1)/page)``)
  are both available — no mid-flight OOM, no preemption needed;
- **retirement**: a sequence that produced its last token frees its
  pages at the NEXT tick boundary, BEFORE that tick's admissions —
  finished sequences release capacity immediately and the freed
  pages/slot are reusable in the same tick;
- **bucketed shapes** (the no-recompile invariant): the decode batch
  is padded to the smallest ``batch_bucket`` >= live count, and the
  block-table width to the smallest power-of-two page count covering
  the longest live sequence — every (batch, width) pair the engine
  can see comes from a finite, precomputed set, so membership churn
  never recompiles or repads live state.

``simulate`` replays a request set through a scheduler counting
decode ticks (prefill cost is identical across policies for the same
set), which is how the bench proves continuous batching strictly
beats static batching on ragged lengths: a static batch decodes
``max(len)`` ticks per group while continuous backfills retired slots
the very tick they free.

**Span emission**: when constructed with a ``recorder`` (anything
with ``.emit(event, **fields)``), the scheduler narrates every
admission decision into the request-lifecycle span stream: ``submit``
on accept, ``blocked`` with its reason (``pages``/``slots``) once per
tick a waiter stays out, ``admit`` with the pages granted, one
``tick`` row per planned step (members, bucket shape, pool occupancy)
and ``retire`` when the pages free.  ``recorder=None`` (the default,
and all the port's engine passes until its tracing is ported) emits
nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

SCRATCH_PAGE = 0


def shape_buckets(max_value: int, floor: int = 1) -> Tuple[int, ...]:
    """Power-of-two bucket ladder ``(floor, 2*floor, ...)`` capped at
    (and always containing) ``max_value`` — the finite shape set both
    the batch and the block-table width draw from."""
    if max_value < 1:
        raise ValueError(f"max_value={max_value} must be >= 1")
    out: List[int] = []
    b = max(1, floor)
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return tuple(out)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class BlockAllocator:
    """Free-list page allocator over a pool of ``num_pages``. Page 0
    is reserved as the SCRATCH page (dead batch slots write there), so
    ``usable`` = num_pages - 1.  LIFO reuse keeps the hot pages hot.

    ``faults``: an optional serving/faults.FaultPlan — allocation
    calls are numbered 0, 1, 2, ... and a call the plan names fails
    (returns None, indistinguishable from pool exhaustion to the
    caller).  None (the default) injects nothing and costs one
    attribute check."""

    def __init__(self, num_pages: int, page_size: int, faults=None):
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages} must be >= 2 "
                             f"(page 0 is the reserved scratch page)")
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.faults = faults
        self.alloc_calls = 0
        self.injected_fails = 0
        self._free: List[int] = list(range(num_pages - 1, SCRATCH_PAGE,
                                           -1))

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - self.free_count

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages or None (all-or-nothing: a partial grant would
        deadlock admission)."""
        call = self.alloc_calls
        self.alloc_calls += 1
        if self.faults is not None and self.faults.fail_alloc(call):
            self.injected_fails += 1
            return None
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        return got

    def free(self, pages: List[int]) -> None:
        seen = set(self._free)
        for p in pages:
            if not (SCRATCH_PAGE < p < self.num_pages):
                raise ValueError(f"freed page {p} outside the pool")
            if p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        self._free.extend(reversed(pages))


@dataclasses.dataclass
class SeqState:
    """One request's scheduler-side state. Lengths only — the token
    arrays live in the engine."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    pages: List[int] = dataclasses.field(default_factory=list)
    generated: int = 0
    finish_t: Optional[float] = None
    # absolute deadline on the scheduler's ``now`` clock (tick count
    # in simulation, wall clock live); None = no deadline
    deadline: Optional[float] = None
    # engine-supervision retry count (how many crashes this request
    # already survived via requeue)
    attempts: int = 0
    # W3C trace context: the 32-hex trace id this request
    # carries on every span it emits, stable across requeue (a
    # supervised restart keeps the chain unbroken); parent_id is the
    # caller's 16-hex span id when a traceparent arrived at the edge
    trace_id: Optional[str] = None
    parent_id: Optional[str] = None

    @property
    def length(self) -> int:
        """Tokens known so far (prompt + generated)."""
        return self.prompt_len + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """What the engine executes this tick: ``prefills`` are the rids
    admitted at this boundary (one batched-forward prefill each),
    ``decodes`` the rids taking a decode step, padded to
    ``batch_bucket`` slots with the block table ``kv_pages`` pages
    wide.  Either list may be empty (a pure-prefill or pure-decode
    tick)."""

    prefills: Tuple[int, ...]
    decodes: Tuple[int, ...]
    batch_bucket: int
    kv_pages: int


class ContinuousScheduler:
    """Iteration-level (Orca-style) scheduler: every tick boundary
    retires, then admits, then plans one shared decode step over the
    live ragged batch."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 recorder=None, faults=None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        self.alloc = BlockAllocator(num_pages, page_size, faults=faults)
        self.page_size = page_size
        self.max_batch = max_batch
        self.batch_buckets = shape_buckets(max_batch)
        # widest table a sequence can need: every usable page
        self.kv_page_buckets = shape_buckets(self.alloc.usable)
        self.waiting: List[SeqState] = []
        self.live: List[SeqState] = []
        self.finished: Dict[int, SeqState] = {}
        self.ticks = 0
        self.decode_slots = 0       # slot-ticks executed (live work)
        self.occupancy_samples: List[float] = []
        # request-lifecycle span emission (obs/spans.SpanRecorder, or
        # anything with .emit(event, **fields)) — INJECTED so the
        # scheduler module itself stays jax- and obs-free; None = off
        self.recorder = recorder
        # deadline/cancel machinery: rids marked for cancellation are
        # retired at the next tick boundary exactly like an expired
        # deadline (same page-freeing path, reason "cancel"); the
        # boundary's typed expirations accumulate in _expired until
        # the engine drains them via take_expired()
        self._cancelled: set = set()
        self._expired: List[Tuple[int, str]] = []
        self.timeouts = 0
        # brownout verdict for THIS boundary, set by the engine before
        # plan_tick: (clamp_new_tokens, admit_per_tick) or None.  The
        # scheduler only applies it — the policy (thresholds,
        # hysteresis) lives in serving/admission.py
        self.brownout: Optional[Tuple[int, int]] = None
        self.brownout_clamped = 0

    def _emit(self, event: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.emit(event, **fields)

    # ---- request surface ----
    def submit(self, rid: int, prompt_len: int, max_new_tokens: int,
               arrival: float = 0.0,
               deadline: Optional[float] = None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               fingerprint: Optional[List[str]] = None) -> None:
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be "
                             ">= 1")
        need = self._pages_for(prompt_len, max_new_tokens)
        if need > self.alloc.usable:
            raise ValueError(
                f"request {rid} needs {need} pages; the pool only has "
                f"{self.alloc.usable} usable")
        self.waiting.append(SeqState(rid, prompt_len, max_new_tokens,
                                     arrival=arrival,
                                     deadline=deadline,
                                     trace_id=trace_id,
                                     parent_id=parent_id))
        # emitted on ACCEPT only (validation above raises first), so
        # the span stream's submit events mirror requests_total
        extra = ({"deadline": float(deadline)}
                 if deadline is not None else {})
        if trace_id is not None:
            extra["trace_id"] = str(trace_id)
        if parent_id is not None:
            extra["parent_id"] = str(parent_id)
        if fingerprint:
            # prompt-block hashes (v10): workload capture reads these
            # off the submit span — the scheduler stays content-free
            extra["fingerprint"] = [str(f) for f in fingerprint]
        self._emit("submit", rid=rid, prompt_len=int(prompt_len),
                   max_new_tokens=int(max_new_tokens),
                   arrival=float(arrival), **extra)

    def requeue(self, s: SeqState) -> None:
        """Put a previously-admitted request back on the waiting
        queue with its work discarded (pages must already be freed by
        the caller's teardown; generated tokens are re-earned by a
        fresh prefill).  Engine supervision's re-admission path — no
        ``submit`` span is emitted (the rid already has one; the
        engine narrates the ``requeue`` event itself)."""
        if s.pages:
            raise ValueError(f"requeue of rid {s.rid} still holding "
                             f"pages {s.pages}")
        s.generated = 0
        s.finish_t = None
        self.waiting.append(s)

    def cancel(self, rid: int) -> bool:
        """Mark ``rid`` for cancellation: the next tick boundary
        retires it through the deadline path (pages freed, typed
        ``timeout`` terminal with reason "cancel").  Returns False for
        a rid that is not waiting or live (already terminal)."""
        known = any(s.rid == rid for s in self.waiting) \
            or any(s.rid == rid for s in self.live)
        if known:
            self._cancelled.add(rid)
        return known

    def take_expired(self) -> List[Tuple[int, str]]:
        """Drain the (rid, reason) pairs retired by deadline expiry or
        cancellation since the last call — the engine finalizes their
        results from this list right after each ``plan_tick``."""
        out, self._expired = self._expired, []
        return out

    def _expire(self, now: float, tick: int) -> None:
        """Retire every waiting/live request whose deadline has passed
        or that was cancelled — pages freed BEFORE retirement and
        admission look at the pool, one typed ``timeout`` span each."""
        for s in list(self.waiting):
            reason = self._expiry_reason(s, now)
            if reason is None:
                continue
            self.waiting.remove(s)
            self._retire_expired(s, reason, tick, waited=True)
        for s in list(self.live):
            if s.done:
                # finished last boundary, awaiting retirement: its
                # tokens were delivered IN time — the deadline race
                # resolves in favor of completed work
                continue
            reason = self._expiry_reason(s, now)
            if reason is None:
                continue
            self.live.remove(s)
            self.alloc.free(s.pages)
            s.pages = []
            self._retire_expired(s, reason, tick, waited=False)

    def _expiry_reason(self, s: SeqState, now: float) -> Optional[str]:
        if s.rid in self._cancelled:
            return "cancel"
        if s.deadline is not None and now > s.deadline:
            return "deadline"
        return None

    def _retire_expired(self, s: SeqState, reason: str, tick: int,
                        waited: bool) -> None:
        self._cancelled.discard(s.rid)
        self._expired.append((s.rid, reason))
        self.timeouts += 1
        self._emit("timeout", rid=s.rid, reason=reason, tick=tick,
                   generated=int(s.generated), queued=bool(waited))

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        # rows written run 0 .. prompt+max_new-2: the final token is
        # emitted by writing row total-2, so it never needs its own row
        return max(1, math.ceil((prompt_len + max_new - 1)
                                / self.page_size))

    # ---- tick boundary ----
    def plan_tick(self, now: float = float("inf")) -> Optional[TickPlan]:
        """Retire finished sequences (freeing their pages), admit
        arrived waiters while slots and pages last, and return the
        tick's plan — None when nothing is live or admissible (the
        engine idles).  ``now``: admission considers requests with
        ``arrival <= now`` only (tick-count clock in simulation, wall
        clock live)."""
        # 0-based boundary index every span event at this boundary
        # shares (the step-index the SLO windows slide over)
        tick = self.ticks
        # 0) expire: deadlines/cancellations free their pages first —
        # a request past its deadline must not hold capacity that
        # could admit a request that can still make its own
        self._expire(now, tick)
        # 1) retire: pages return BEFORE admission looks at the pool
        for s in [s for s in self.live if s.done]:
            self.live.remove(s)
            self.alloc.free(s.pages)
            s.pages = []
            self.finished[s.rid] = s
            # a cancel that lost the race to completion must not
            # leak its marker for the scheduler's lifetime
            self._cancelled.discard(s.rid)
            self._emit("retire", rid=s.rid, generated=s.generated,
                       finish_t=float(s.finish_t or 0.0), tick=tick)
        # 2) admit FIFO among the arrived (under the boundary's
        # brownout verdict, when the engine set one: admission width
        # capped, new admissions' token budgets clamped)
        clamp = admit_cap = None
        if self.brownout is not None:
            clamp, admit_cap = self.brownout
        prefills: List[int] = []
        for s in list(self.waiting):
            if s.arrival > now:
                continue                  # not arrived ≠ blocked
            if admit_cap is not None and len(prefills) >= admit_cap:
                # brownout admission-width cap: the queue drains at a
                # bounded rate until the pressure signal clears
                self._emit("blocked", rid=s.rid, reason="brownout",
                           tick=tick)
                break
            if len(self.live) >= self.max_batch:
                self._emit("blocked", rid=s.rid, reason="slots",
                           tick=tick)
                continue
            # degrade, don't refuse: a clamped answer reserves fewer
            # pages and frees its slot sooner.  The budget mutation,
            # counter and admit tag land ONLY on a successful
            # admission — a clamped-then-blocked request must keep
            # its submitted budget (or its retire would contradict
            # the submit span with no clamped tag to exempt it)
            eff_new = s.max_new_tokens
            if clamp is not None and eff_new > clamp:
                eff_new = clamp
            pages = self.alloc.alloc(
                self._pages_for(s.prompt_len, eff_new))
            if pages is None:
                # head-of-line blocks on pages: smaller requests behind
                # it must not starve it forever — stop admitting
                self._emit("blocked", rid=s.rid, reason="pages",
                           tick=tick)
                break
            clamped = eff_new < s.max_new_tokens
            if clamped:
                s.max_new_tokens = eff_new
                self.brownout_clamped += 1
            s.pages = pages
            self.waiting.remove(s)
            self.live.append(s)
            prefills.append(s.rid)
            extra = {"clamped": True} if clamped else {}
            self._emit("admit", rid=s.rid, pages_held=len(pages),
                       tick=tick, **extra)
        if not self.live:
            return None
        decodes = [s.rid for s in self.live if not s.done]
        # block-table width covers only the rows this tick can touch
        # (decode at pos = projected_length - 1): LIVE blocks, not the
        # full reservation — the paged gather's whole point.  A
        # max_new_tokens=1 prefill finishes WITHOUT a same-tick decode
        # (the engine filters done rids), so it projects no extra row —
        # the +1 would otherwise overflow the reservation (and the
        # width ladder) when the prompt fills its last page
        prefset = set(prefills)
        rows = max(s.length
                   + (1 if s.rid in prefset and s.max_new_tokens > 1
                      else 0)
                   for s in self.live)
        width = max(1, math.ceil(rows / self.page_size))
        plan = TickPlan(
            prefills=tuple(prefills),
            decodes=tuple(decodes),
            batch_bucket=bucket_for(len(decodes) or 1,
                                    self.batch_buckets),
            kv_pages=bucket_for(width, self.kv_page_buckets),
        )
        self.ticks += 1
        self.decode_slots += len(decodes)
        occ = self.alloc.in_use / self.alloc.usable
        self.occupancy_samples.append(occ)
        self._emit("tick", tick=tick, rids=list(decodes),
                   batch=len(decodes), batch_bucket=plan.batch_bucket,
                   kv_pages=plan.kv_pages, occupancy=round(occ, 6))
        return plan

    def record_prefill(self, rid: int, now: float = 0.0) -> None:
        """A prefill produced the request's FIRST generated token."""
        self._seq(rid).generated += 1
        self._maybe_finish(rid, now)

    def record_decode(self, rids, now: float = 0.0) -> None:
        """One decode tick produced one token for each rid."""
        for rid in rids:
            self._seq(rid).generated += 1
            self._maybe_finish(rid, now)

    def _maybe_finish(self, rid: int, now: float) -> None:
        s = self._seq(rid)
        if s.done and s.finish_t is None:
            s.finish_t = now

    def _seq(self, rid: int) -> SeqState:
        for s in self.live:
            if s.rid == rid:
                return s
        raise KeyError(f"rid {rid} is not live")

    @property
    def idle(self) -> bool:
        return not self.live and not self.waiting

    def occupancy(self) -> float:
        """Mean cache-page occupancy over the ticks planned so far."""
        if not self.occupancy_samples:
            return 0.0
        return sum(self.occupancy_samples) / len(self.occupancy_samples)


class StaticBatchScheduler(ContinuousScheduler):
    """The baseline policy: admit in groups of up to ``max_batch`` and
    hold the group until EVERY member finishes (classic offline
    batching — what ``generate_dp`` does today).  Same allocator, same
    plan surface, so ``simulate`` compares the two policies on the
    identical request set."""

    def plan_tick(self, now: float = float("inf")) -> Optional[TickPlan]:
        tick = self.ticks
        # deadlines/cancellations expire identically under both
        # policies (the same typed-terminal contract)
        self._expire(now, tick)
        # retire pages as sequences finish (memory is freed either
        # way; the STATIC restriction is about slots, not pages)
        for s in [s for s in self.live if s.done and s.pages]:
            self.alloc.free(s.pages)
            s.pages = []
        if self.live and all(s.done for s in self.live):
            for s in self.live:
                self.finished[s.rid] = s
                self._cancelled.discard(s.rid)
                self._emit("retire", rid=s.rid, generated=s.generated,
                           finish_t=float(s.finish_t or 0.0),
                           tick=tick)
            self.live = []
        prefills: List[int] = []
        if not self.live:
            # next group: fill up to max_batch from the arrived queue
            for s in list(self.waiting):
                if s.arrival > now:
                    continue
                if len(self.live) >= self.max_batch:
                    self._emit("blocked", rid=s.rid, reason="slots",
                               tick=tick)
                    continue
                pages = self.alloc.alloc(
                    self._pages_for(s.prompt_len, s.max_new_tokens))
                if pages is None:
                    self._emit("blocked", rid=s.rid, reason="pages",
                               tick=tick)
                    break
                s.pages = pages
                self.waiting.remove(s)
                self.live.append(s)
                prefills.append(s.rid)
                self._emit("admit", rid=s.rid,
                           pages_held=len(pages), tick=tick)
        if not self.live:
            return None
        decodes = [s.rid for s in self.live if not s.done]
        if not decodes and not prefills:
            return None
        prefset = set(prefills)
        rows = max(s.length
                   + (1 if s.rid in prefset and s.max_new_tokens > 1
                      else 0)
                   for s in self.live if not s.done)
        width = max(1, math.ceil(rows / self.page_size))
        plan = TickPlan(
            prefills=tuple(prefills), decodes=tuple(decodes),
            # static batching pads every tick to the FULL group bucket:
            # finished members keep their slot until the group retires
            batch_bucket=bucket_for(max(len(self.live), 1),
                                    self.batch_buckets),
            kv_pages=bucket_for(max(width, 1), self.kv_page_buckets),
        )
        self.ticks += 1
        self.decode_slots += len(decodes)
        occ = self.alloc.in_use / self.alloc.usable
        self.occupancy_samples.append(occ)
        self._emit("tick", tick=tick, rids=list(decodes),
                   batch=len(decodes), batch_bucket=plan.batch_bucket,
                   kv_pages=plan.kv_pages, occupancy=round(occ, 6))
        return plan


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Deterministic tick-count accounting for one policy over one
    request set (latencies in TICKS — the analytic, gateable number;
    the engine measures wall-clock on top)."""

    decode_ticks: int
    total_ticks: int
    finish_ticks: Dict[int, float]
    latency_ticks: Dict[int, float]
    occupancy: float
    shapes: Tuple[Tuple[int, int], ...]   # (batch_bucket, kv_pages) seen


def simulate(scheduler: ContinuousScheduler,
             requests) -> SimResult:
    """Drive ``scheduler`` over ``requests`` (iterable of
    ``(rid, prompt_len, max_new_tokens[, arrival])``) counting ticks:
    each planned tick costs 1 (its prefills + the shared decode step),
    matching the engine's execution shape.  Pure Python — the bench's
    continuous-vs-static comparison and the tier-1 scheduler tests
    run this without jax."""
    for req in requests:
        scheduler.submit(*req)
    t = 0.0
    shapes = set()
    guard = 0
    while not scheduler.idle:
        plan = scheduler.plan_tick(now=t)
        t += 1.0
        if plan is None:
            continue
        shapes.add((plan.batch_bucket, plan.kv_pages))
        for rid in plan.prefills:
            scheduler.record_prefill(rid, now=t)
        scheduler.record_decode(
            [r for r in plan.decodes
             if not scheduler._seq(r).done], now=t)
        guard += 1
        if guard > 10_000_000:
            raise RuntimeError("simulation did not converge")
    finish = {rid: s.finish_t for rid, s in scheduler.finished.items()}
    latency = {rid: s.finish_t - s.arrival
               for rid, s in scheduler.finished.items()}
    return SimResult(
        decode_ticks=scheduler.ticks, total_ticks=int(t),
        finish_ticks=finish, latency_ticks=latency,
        occupancy=scheduler.occupancy(), shapes=tuple(sorted(shapes)))
