"""DecodeEngine: continuous-batching inference over the paged cache.

The execution half of the serving stack: the pure-Python scheduler
(``serving/scheduler.py``) decides membership and shapes, this engine
executes each ``TickPlan`` on the device:

- one **prefill** per admitted request, at its bucketed prompt width —
  the block forward over the whole prompt, captured into the request's
  pages, emitting the first generated token;
- one **decode** step per tick over the live ragged batch, padded to a
  batch bucket with a block table of a bucketed width, with sampling
  on the device (greedy argmax / temperature draw per sequence), so
  the logits never leave the card; only the [B] sampled tokens do.

The shapes come from the same finite bucket ladders as the JAX
package's engine.  PyTorch runs eagerly, so nothing is compiled per
shape here; the buckets still matter: under ``fp8_ffn`` the
per-tensor scales span the whole padded batch (dead decode slots and
prefill pad rows included), so the port feeds exactly the batches the
JAX engine feeds and its numbers match.

Request surface and fail-open behaviour follow the JAX package's
engine: ``submit`` / ``result`` / ``cancel`` / ``step`` /
``run_until_idle`` / ``start`` / ``stop`` / ``stats``, deadlines, a
bounded queue (``max_queue``, typed ``ShedError``), brownout on page
occupancy and on the fast-window SLO burn rate, and ``engine_retries``
supervision with bounded backoff.  A span recorder
(``obs/spans.SpanRecorder``) threads both layers: the scheduler
narrates admission, the engine adds the execution milestones at the
JAX engine's sites, with its event names and fields, in its order.  A
restart narrator (``resilience/restart.RestartNarrator``) gets one
``engine_restart`` row per supervised restart.  The fleet router
(``serving/router.py``) reads ``waiting_rids()`` and ``fast_burn()``
and fails requests over with ``submit(attempts=)``.

Thread model: ``submit()`` may be called from any thread (the HTTP
handlers); ``step()`` — or the ``start()``-ed background loop —
executes ticks under the engine lock.
"""

from __future__ import annotations

import collections
import math
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kv_cache as kvc
from . import scheduler as sched_lib
from ..device import DeviceLike, resolve_device
from ..obs.spans import new_trace_id, parse_traceparent
from ..resilience.restart import backoff_s
from .admission import BrownoutPolicy, ShedError, retry_after_hint
from .faults import InjectedFault
from .scheduler import SCRATCH_PAGE

# rolling window for the latency percentiles stats() reports
STATS_WINDOW = 2048
# brownout burn-rate recompute cadence, in tick boundaries: the SLO
# fold over the span ring is O(ring), too heavy for every tick
BURN_EVERY = 32
# supervised-restart backoff: base doubles per consecutive crash up to
# the cap, and resets on the first healthy tick
RESTART_BACKOFF_BASE_S = 0.05
RESTART_BACKOFF_MAX_S = 2.0
# completed requests retained for result() pickup before the oldest
# are evicted
RETAIN_FINISHED = 4096


def _percentile(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    return float(np.percentile(vals, q * 100.0))


class _Result:
    __slots__ = ("event", "prompt", "tokens", "arrival_t", "first_t",
                 "finish_t", "error", "status", "attempts")

    def __init__(self, prompt, arrival_t: float):
        self.event = threading.Event()
        self.prompt = prompt
        self.tokens: List[int] = []
        self.arrival_t = arrival_t
        self.first_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.error: Optional[str] = None
        self.attempts: Optional[int] = None
        # "result" | "timeout" | "failed" once the event is set
        self.status: Optional[str] = None


class DecodeEngine:
    """Continuous-batching decode over a paged KV cache on ``device``
    (None = the card; ``"cpu"`` must be asked for).

    ``num_pages=0`` sizes the pool for ``max_batch`` worst-case
    (``max_len``) sequences plus the scratch page; ``max_len`` (prompt
    + generated) defaults to, and may not exceed, ``spec.seq_len``.
    ``seed`` seeds the sampling generators: request ``rid``'s prefill
    draws from seed domain ``2*rid`` and decode tick ``t`` from
    ``2*t+1``, the JAX engine's even/odd split.

    Fail-open knobs (off by default): ``max_queue`` (typed shedding),
    ``deadline_ms`` (typed ``timeout`` terminal), ``brownout``
    (admission.BrownoutPolicy on page occupancy and, with a recorder,
    the fast-window burn rate of ``slos``: obs/slo.SLOSpec list, None =
    the defaults), ``engine_retries`` (supervised restart with
    re-queue; ``restart_narrator``, a resilience/restart.RestartNarrator,
    narrates each restart), ``faults`` (faults.FaultPlan).  ``recorder``
    (obs/spans.SpanRecorder) records every request's lifecycle;
    ``kv_quant="int8"`` stores the paged pools as int8 with scale
    planes.
    """

    def __init__(self, spec, params, page_size: int = 16,
                 num_pages: int = 0, max_batch: int = 8,
                 max_len: int = 0, seed: int = 0, kv_quant: str = "",
                 recorder=None, max_queue: int = 0,
                 deadline_ms: float = 0.0, engine_retries: int = 0,
                 brownout: Optional[BrownoutPolicy] = None,
                 faults=None, slos=None, restart_narrator=None,
                 device: DeviceLike = None):
        if spec.objective != "lm":
            raise ValueError("the decode engine serves the lm "
                             "objective only")
        self.device = resolve_device(device)
        self.spec = spec
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.page_size = int(page_size)
        self.kv_quant = str(kv_quant or "")
        self.max_len = int(max_len) or spec.seq_len
        if self.max_len > spec.seq_len:
            raise ValueError(
                f"max_len={self.max_len} exceeds the positional "
                f"table's seq_len={spec.seq_len}")
        pages_per_seq = max(1, math.ceil((self.max_len - 1)
                                         / self.page_size))
        self.num_pages = int(num_pages) or 1 + max_batch * pages_per_seq
        self.recorder = recorder
        self.faults = faults
        self.max_queue = int(max_queue)
        self.deadline_ms = float(deadline_ms)
        self.engine_retries = int(engine_retries)
        if self.max_queue < 0 or self.deadline_ms < 0 \
                or self.engine_retries < 0:
            raise ValueError("max_queue, deadline_ms and "
                             "engine_retries must be >= 0")
        self.brownout = brownout
        self.slos = slos
        self.restart_narrator = restart_narrator
        self.max_batch = int(max_batch)
        self.sched = sched_lib.ContinuousScheduler(
            self.num_pages, self.page_size, max_batch,
            recorder=recorder, faults=faults)
        self.prompt_buckets = sched_lib.shape_buckets(
            max(1, self.max_len - 1))
        self._heads = kvc.local_heads(spec, self.params)
        self.cache = self._new_cache()
        self._seed = int(seed)
        self._lock = threading.RLock()
        self._results: Dict[int, _Result] = {}
        self._temps: Dict[int, float] = {}
        self._last_tok: Dict[int, int] = {}
        self._finished_order: collections.deque = collections.deque()
        self._lat_ms: collections.deque = collections.deque(
            maxlen=STATS_WINDOW)
        self._ttft_ms: collections.deque = collections.deque(
            maxlen=STATS_WINDOW)
        self._completed = 0
        self._failure: Optional[str] = None
        self._traces: Dict[int, tuple] = {}
        # rid -> the attempts count seeded by submit(attempts=): the
        # local retry budget bounds the crashes THIS engine absorbs, so
        # the budget check offsets by it while spans keep the cumulative
        # fleet-wide count
        self._attempt_base: Dict[int, int] = {}
        self._next_rid = 0
        self._accepted = 0
        self._tick = 0
        self._prefills = 0
        self._tokens_out = 0
        self._shed = 0
        self._timeouts = 0
        self._failed = 0
        self._requeued = 0
        self._restarts = 0
        self._queue_peak = 0
        self._brownout_active = False
        self._brownout_clamped = 0
        self._consec_crashes = 0
        # monotonic tick-boundary counter: the FaultPlan clock (a
        # supervised restart resets the scheduler's own tick count)
        self._boundaries = 0
        self._burn_cache: Tuple[int, Optional[float]] = (-BURN_EVERY,
                                                         None)
        self._started_t: Optional[float] = None
        self.shapes_used: set = set()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._work = threading.Condition()

    def _new_cache(self) -> dict:
        return kvc.init_paged_cache(self.spec, self.num_pages,
                                    self.page_size, heads=self._heads,
                                    quant=self.kv_quant, device=self.device)

    def _generator(self, domain: int) -> torch.Generator:
        """The sampling generator of one seed domain (even: a request's
        prefill, odd: a decode tick)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self._seed * 0x9E3779B97F4A7C15 + domain)
                      % (1 << 63))
        return g

    # ---- request surface ----
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_ms: Optional[float] = None,
               traceparent: Optional[str] = None,
               attempts: int = 0,
               fingerprint: Optional[list] = None) -> int:
        """Queue a request (``prompt``: iterable of int token ids);
        returns its rid.  Thread-safe.  ``deadline_ms`` bounds the
        request's time in the system (None = the engine default; 0 =
        none).  Raises ``ShedError`` when the bounded queue is full.
        ``traceparent`` (W3C) carries the caller's trace id onto the
        result and onto every span the request emits.  ``attempts``
        seeds the supervision retry ledger (a router failing a request
        over passes the count the old engine burned, so
        ``engine_retries`` bounds the crashes this engine absorbs on
        top); ``fingerprint`` replaces the submit span's prompt
        fingerprint (a replay passes the recorded one)."""
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            trace_id, parent_id = ctx
        else:
            trace_id, parent_id = new_trace_id(), None
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.spec.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocabulary")
        if len(prompt) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        now = time.monotonic()
        with self._lock:
            if self._failure is not None:
                raise RuntimeError(
                    f"decode engine failed: {self._failure}")
            if self.max_queue and len(self.sched.waiting) >= self.max_queue:
                # the shed rid is consumed (span-stream rids stay
                # unique); requests_total counts accepted ones only
                rid = self._next_rid
                self._next_rid += 1
                self._shed += 1
                retry_s = self._retry_after_s()
                if self.recorder is not None:
                    extra = {"trace_id": trace_id}
                    if parent_id is not None:
                        extra["parent_id"] = parent_id
                    self.recorder.emit(
                        "shed", rid=rid, reason="queue",
                        tick=self.sched.ticks,
                        queued=len(self.sched.waiting), **extra)
                raise ShedError(
                    f"queue full ({len(self.sched.waiting)} waiting, "
                    f"max_queue={self.max_queue})",
                    retry_after_s=retry_s, rid=rid)
            dl_ms = self.deadline_ms if deadline_ms is None \
                else float(deadline_ms)
            deadline = now + dl_ms / 1e3 if dl_ms > 0 else None
            rid = self._next_rid
            # the prompt-block fingerprint rides the submit span
            if fingerprint is None and self.recorder is not None:
                from ..obs.workload import prompt_fingerprint

                fingerprint = prompt_fingerprint(prompt)
            self.sched.submit(rid, len(prompt), int(max_new_tokens),
                              arrival=now, deadline=deadline,
                              trace_id=trace_id, parent_id=parent_id,
                              fingerprint=fingerprint)
            if attempts:
                # a failed-over request arrives mid-ledger: the seq
                # carries the cumulative count, the base offsets the
                # local budget check in _recover
                self.sched.waiting[-1].attempts = int(attempts)
                self._attempt_base[rid] = int(attempts)
            self._next_rid += 1
            self._accepted += 1
            self._queue_peak = max(self._queue_peak,
                                   len(self.sched.waiting))
            self._results[rid] = _Result(prompt, now)
            self._temps[rid] = float(temperature)
            self._traces[rid] = (trace_id, parent_id)
        with self._work:
            self._work.notify()
        return rid

    def trace_context(self, rid: int) -> Optional[tuple]:
        """``(trace_id, parent_id)`` for an accepted rid, else None."""
        with self._lock:
            return self._traces.get(int(rid))

    def _retry_after_s(self) -> float:
        return retry_after_hint(_percentile(list(self._lat_ms), 0.50))

    def waiting_rids(self) -> List[int]:
        """Rids still waiting for admission (no pages, no tokens): the
        router's drain typed-cancels exactly these."""
        with self._lock:
            return [s.rid for s in self.sched.waiting]

    def fast_burn(self) -> Optional[float]:
        """The cached fast-window SLO burn rate (None without a
        recorder): ``_fast_burn`` under the engine lock, for the
        router's health probes from other threads."""
        with self._lock:
            return self._fast_burn()

    def cancel(self, rid: int) -> bool:
        """Retire ``rid`` at the next tick boundary (typed ``timeout``
        terminal, reason "cancel").  False when unknown or already
        terminal."""
        with self._lock:
            res = self._results.get(rid)
            if res is None or res.event.is_set():
                return False
            ok = self.sched.cancel(rid)
        with self._work:
            self._work.notify()
        return ok

    def result(self, rid: int, timeout: Optional[float] = None):
        """Block until rid completes: ``{"rid", "status": "result",
        "prompt", "tokens", "latency_ms", "ttft_ms", "trace_id"}``, or
        ``{"rid", "status", "error", "trace_id"}`` for a typed
        ``timeout``/``failed`` terminal, or None when ``timeout``
        elapsed first."""
        res = self._results[rid]
        if not res.event.wait(timeout):
            return None
        trace = self._traces.get(rid)
        extra = {"trace_id": trace[0]} if trace else {}
        if res.error is not None:
            out = {"rid": rid, "status": res.status or "failed",
                   "error": res.error, **extra}
            if res.attempts is not None:
                out["attempts"] = res.attempts
            return out
        return {
            "rid": rid,
            "status": "result",
            "prompt": list(res.prompt),
            "tokens": list(res.tokens),
            "latency_ms": round((res.finish_t - res.arrival_t) * 1e3, 3),
            "ttft_ms": round((res.first_t - res.arrival_t) * 1e3, 3),
            **extra,
        }

    # ---- execution ----
    def step(self) -> bool:
        """Execute one scheduler tick (admissions' prefills + the
        shared decode step); False when there was nothing to do.  The
        order at each boundary: brownout verdict -> plan (expiring
        deadlines/cancels first) -> finalize expirations -> injected
        crash/stall -> execute."""
        with self._lock:
            t0 = time.monotonic()
            if self._started_t is None:
                self._started_t = t0
            self._update_brownout()
            plan = self.sched.plan_tick(now=t0)
            self._finalize_expired(self.sched.take_expired(), t0)
            self.sched.finished.clear()
            if plan is None:
                return False
            boundary = self._boundaries
            self._boundaries += 1
            if self.faults is not None:
                if self.faults.crash(boundary):
                    raise InjectedFault(
                        f"injected crash at tick boundary {boundary}")
                stall = (self.faults.stall(boundary)
                         + self.faults.delay_s)
                if stall > 0:
                    time.sleep(stall)
            exec_t0 = time.monotonic()
            for rid in plan.prefills:
                self._run_prefill(rid)
            decodes = [r for r in plan.decodes
                       if not self.sched._seq(r).done]
            if decodes:
                self._run_decode(decodes, plan)
            if self.recorder is not None:
                # close the tick the scheduler's tick row opened:
                # dur_ms is the execution wall only, so an injected
                # stall shows up as the waterfall's decode_stall
                self.recorder.emit(
                    "tick_done", tick=self.sched.ticks - 1,
                    dur_ms=round((time.monotonic() - exec_t0) * 1e3, 3))
            self._consec_crashes = 0
            return True

    def _update_brownout(self) -> None:
        if self.brownout is None:
            return
        occ = self.sched.alloc.in_use / self.sched.alloc.usable
        self._brownout_active = self.brownout.update(
            self._brownout_active, occ, self._fast_burn())
        self.sched.brownout = (
            (self.brownout.clamp_new_tokens,
             self.brownout.admit_per_tick)
            if self._brownout_active else None)
        self._brownout_clamped = self.sched.brownout_clamped

    def _fast_burn(self) -> Optional[float]:
        """Max fast-window SLO burn rate over the recorder's ring (None
        without a recorder), recomputed every ``BURN_EVERY``
        boundaries."""
        if self.recorder is None:
            return None
        at, val = self._burn_cache
        if self._boundaries - at < BURN_EVERY:
            return val
        from ..obs import slo as slo_lib

        doc = slo_lib.evaluate(
            slo_lib.records_from_spans(self.recorder.snapshot()),
            specs=self.slos)
        burns = [(d.get("windows") or {}).get("fast", {}).get("burn_rate")
                 for d in doc.get("slos") or []]
        burns = [b for b in burns if isinstance(b, (int, float))]
        val = max(burns) if burns else None
        self._burn_cache = (self._boundaries, val)
        return val

    def _finalize_expired(self, pairs, now: float) -> None:
        for rid, reason in pairs:
            res = self._results.get(rid)
            self._timeouts += 1
            if res is None or res.event.is_set():
                continue
            res.status = "timeout"
            res.error = ("cancelled by client" if reason == "cancel"
                         else "deadline exceeded")
            res.finish_t = now
            self._seal(rid, res)

    def run_until_idle(self) -> int:
        """Drive ticks until every submitted request completed; returns
        the number of executed ticks.  Supervision applies as in the
        background loop."""
        n = 0
        while True:
            try:
                did = self.step()
            except Exception as e:  # noqa: BLE001 — supervised loop
                if self.engine_retries > 0 and self._recover(e):
                    continue
                raise
            if not did:
                with self._lock:
                    if self.sched.idle:
                        return n
                time.sleep(0.001)
                continue
            n += 1

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits, temps: np.ndarray, domain: int):
        """[B] sampled tokens as a host array; no noise is drawn when
        every row is greedy."""
        gen = self._generator(domain) if (temps > 0).any() else None
        nxt = kvc.sample_tokens(logits, gen, self._tensor(temps))
        return nxt.cpu().numpy()

    def _run_prefill(self, rid: int) -> None:
        seq = self.sched._seq(rid)
        res = self._results[rid]
        p = len(res.prompt)
        pb = sched_lib.bucket_for(p, self.prompt_buckets)
        wp = max(1, math.ceil(pb / self.page_size))
        self.shapes_used.add(("prefill", pb, wp))
        if self.recorder is not None:
            self.recorder.emit("prefill", rid=rid, bucket=pb,
                               pages_width=wp)
        bt = np.full((1, wp), SCRATCH_PAGE, np.int64)
        own = seq.pages[:wp]
        bt[0, :len(own)] = own
        toks = np.zeros((1, pb), np.int64)
        toks[0, :p] = res.prompt
        logits, self.cache = kvc.prefill_into_pages(
            self.spec, self.params, self.cache, self._tensor(bt),
            self._tensor(toks), self._tensor(np.asarray([p], np.int64)))
        tok = int(self._sample(
            logits, np.asarray([self._temps[rid]], np.float32),
            2 * rid)[0])
        now = time.monotonic()
        res.tokens.append(tok)
        res.first_t = now
        self._last_tok[rid] = tok
        self._prefills += 1
        self._tokens_out += 1
        if self.recorder is not None:
            self.recorder.emit("first_token", rid=rid, ttft_ms=round(
                (now - res.arrival_t) * 1e3, 3))
        self.sched.record_prefill(rid, now=now)
        if seq.done:
            self._finish(rid, now)

    def _run_decode(self, rids: List[int], plan) -> None:
        b, w = plan.batch_bucket, plan.kv_pages
        self.shapes_used.add(("decode", b, w))
        bt = np.full((b, w), SCRATCH_PAGE, np.int64)
        tok = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int64)
        temp = np.zeros((b,), np.float32)
        for i, rid in enumerate(rids):
            seq = self.sched._seq(rid)
            own = seq.pages[:w]
            bt[i, :len(own)] = own
            tok[i] = self._last_tok[rid]
            pos[i] = seq.length - 1
            temp[i] = self._temps[rid]
        self._tick += 1
        logits, self.cache = kvc.paged_decode_step(
            self.spec, self.params, self.cache, self._tensor(bt),
            self._tensor(tok), self._tensor(pos))
        out = self._sample(logits, temp, 2 * self._tick + 1)
        now = time.monotonic()
        for i, rid in enumerate(rids):
            t = int(out[i])
            self._results[rid].tokens.append(t)
            self._last_tok[rid] = t
            self._tokens_out += 1
        self.sched.record_decode(rids, now=now)
        for rid in rids:
            if self.sched._seq(rid).done:
                self._finish(rid, now)

    def _finish(self, rid: int, now: float) -> None:
        res = self._results[rid]
        res.finish_t = now
        res.status = "result"
        self._completed += 1
        self._lat_ms.append((now - res.arrival_t) * 1e3)
        if res.first_t is not None:
            self._ttft_ms.append((res.first_t - res.arrival_t) * 1e3)
        self._seal(rid, res)

    def _seal(self, rid: int, res: "_Result") -> None:
        """The one terminal-sealing path (caller holds the lock)."""
        self._temps.pop(rid, None)
        self._last_tok.pop(rid, None)
        self._finished_order.append(rid)
        while len(self._finished_order) > RETAIN_FINISHED:
            evicted = self._finished_order.popleft()
            self._results.pop(evicted, None)
            self._traces.pop(evicted, None)
            self._attempt_base.pop(evicted, None)
        res.event.set()

    # ---- background loop (the HTTP front door's worker) ----
    def start(self) -> None:
        with self._work:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="dtx-decode-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._work:
            self._running = False
            self._work.notify()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._work:
                if not self._running:
                    return
            try:
                did = self.step()
            except Exception as e:   # noqa: BLE001 — the one thread
                # every request depends on must not die silently
                if self.engine_retries > 0 and self._recover(e):
                    continue
                self._fail(e)
                return
            if not did:
                with self._work:
                    if self._running:
                        self._work.wait(timeout=0.02)
            else:
                # hand the interpreter to a thread blocked in submit():
                # without the yield this thread re-takes the engine lock
                # before the woken submitter runs, and a submit waits
                # until the whole batch drains (seconds on the card)
                time.sleep(0)

    # ---- supervision (engine_retries > 0) ----
    def _recover(self, e: BaseException) -> bool:
        """A tick crashed under supervision: rebuild the scheduler and
        the cache, re-queue every admitted-but-unfinished request (its
        tokens discarded, prefill re-run) unless its retry budget is
        spent (typed ``failed`` terminal), then back off.  Returns
        True (the loop resumes)."""
        msg = f"{type(e).__name__}: {e}"
        now = time.monotonic()
        with self._lock:
            self._restarts += 1
            self._consec_crashes += 1
            old = self.sched
            inflight = list(old.live)
            waiting = list(old.waiting)
            if self.recorder is not None:
                self.recorder.emit(
                    "engine_restart", restart=self._restarts,
                    reason=msg, rids=[s.rid for s in inflight],
                    tick=old.ticks)
            if self.restart_narrator is not None:
                self.restart_narrator.emit(
                    "engine_restart", restart=self._restarts,
                    reason=msg, inflight=len(inflight),
                    queued=len(waiting))
            sys.stderr.write(
                f"dtx-serve: engine loop crashed ({msg}); supervised "
                f"restart {self._restarts} with {len(inflight)} "
                f"in-flight re-queued\n")
            self.sched = sched_lib.ContinuousScheduler(
                self.num_pages, self.page_size, self.max_batch,
                recorder=self.recorder, faults=self.faults)
            # the FaultPlan's clocks and the tick index survive (the
            # span stream's tick index stays monotonic across the
            # restart: the SLO windows and the waterfall slide over it)
            self.sched.alloc.alloc_calls = old.alloc.alloc_calls
            self.sched.alloc.injected_fails = old.alloc.injected_fails
            self.sched.brownout_clamped = old.brownout_clamped
            self.sched.ticks = old.ticks
            self.sched._cancelled = set(old._cancelled)
            self._finalize_expired(old.take_expired(), now)
            self.cache = self._new_cache()
            survivors = []
            for s in inflight:
                s.pages = []          # freed with the dead allocator
                s.attempts += 1
                res = self._results.get(s.rid)
                if res is None or res.event.is_set():
                    continue
                if s.attempts > self.engine_retries \
                        + self._attempt_base.get(s.rid, 0):
                    self._finalize_failed(
                        s.rid, f"engine crashed {s.attempts} times "
                               f"on this request "
                               f"(engine_retries={self.engine_retries}"
                               f"): {msg}",
                        attempts=s.attempts, now=now)
                    continue
                res.tokens.clear()
                res.first_t = None
                self._last_tok.pop(s.rid, None)
                self._requeued += 1
                if self.recorder is not None:
                    # the requeue keeps the request's trace_id
                    extra = ({"trace_id": s.trace_id}
                             if s.trace_id else {})
                    self.recorder.emit("requeue", rid=s.rid,
                                       attempt=s.attempts,
                                       tick=self.sched.ticks, **extra)
                survivors.append(s)
            for s in sorted(survivors + waiting,
                            key=lambda st: (st.arrival, st.rid)):
                self.sched.requeue(s)
            self.sched._cancelled &= {s.rid for s in self.sched.waiting}
            wait_s = backoff_s(self._consec_crashes - 1,
                               base_s=RESTART_BACKOFF_BASE_S,
                               cap_s=RESTART_BACKOFF_MAX_S)
        if wait_s > 0:
            time.sleep(wait_s)
        with self._work:
            self._work.notify()
        return True

    def _finalize_failed(self, rid: int, msg: str, attempts: int,
                         now: float) -> None:
        res = self._results.get(rid)
        if res is None or res.event.is_set():
            return
        self._failed += 1
        res.status = "failed"
        res.error = msg
        res.attempts = int(attempts)
        res.finish_t = now
        if self.recorder is not None:
            trace = self._traces.get(rid)
            extra = {"trace_id": trace[0]} if trace else {}
            self.recorder.emit("failed", rid=rid, reason=msg,
                               attempts=int(attempts), **extra)
        self._seal(rid, res)

    def _fail(self, e: BaseException) -> None:
        """A tick raised without supervision: record the failure,
        refuse new submits, and fail every pending request now."""
        msg = f"{type(e).__name__}: {e}"
        sys.stderr.write(f"dtx-serve: decode engine loop died: {msg}\n"
                         f"{traceback.format_exc()}")
        with self._lock:
            self._failure = msg
            for rid, res in self._results.items():
                if res.finish_t is None and res.error is None:
                    res.error = msg
                    res.status = "failed"
                    self._failed += 1
                    if self.recorder is not None:
                        # no retire follows: mark the lifecycle failed
                        trace = self._traces.get(rid)
                        extra = {"trace_id": trace[0]} if trace else {}
                        self.recorder.emit("error", rid=rid,
                                           reason=msg, **extra)
                    res.event.set()
        with self._work:
            self._running = False

    # ---- observability ----
    def stats(self) -> dict:
        """Point-in-time serving counters and rolling-window latency
        percentiles (the JAX engine's ``stats()`` keys)."""
        with self._lock:
            lats = list(self._lat_ms)
            ttfts = list(self._ttft_ms)
            wall = (time.monotonic() - self._started_t
                    if self._started_t is not None else 0.0)
            toks = self._tokens_out
            occ = self.sched.alloc.in_use / self.sched.alloc.usable
            return {
                "requests_total": self._accepted,
                "completed_total": self._completed,
                "inflight": len(self.sched.live),
                "queued": len(self.sched.waiting),
                "latency_p50_ms": _percentile(lats, 0.50),
                "latency_p99_ms": _percentile(lats, 0.99),
                "ttft_p50_ms": _percentile(ttfts, 0.50),
                "ttft_p99_ms": _percentile(ttfts, 0.99),
                "tokens_generated_total": toks,
                "tokens_per_sec": (toks / wall if wall > 0 and toks
                                   else None),
                "page_occupancy_frac": round(occ, 6),
                "decode_ticks_total": self._tick,
                "prefills_total": self._prefills,
                "shed_total": self._shed,
                "timeout_total": self._timeouts,
                "failed_total": self._failed,
                "requeued_total": self._requeued,
                "engine_restarts_total": self._restarts,
                "queue_limit": self.max_queue,
                "queue_peak": self._queue_peak,
                "brownout_active": int(self._brownout_active),
                "brownout_clamped_total": self._brownout_clamped,
                "kv_quant": self.kv_quant,
            }
