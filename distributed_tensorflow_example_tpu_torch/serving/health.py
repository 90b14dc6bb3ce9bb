"""Per-replica health scoring and circuit breakers — the port's copy of
the JAX package's ``serving/health.py``; pure Python.

The router (``serving/router.py``) needs a decision layer over the
signals one engine exports: "is this replica a good place for the next
request, and when do we stop asking a sick one?"  Both policies are
closed-form decision tables with no threads and no wall-clock reads
except through an injectable clock:

- **health score** (``health_score``): one scalar in [0, 1] per replica
  from queue depth against its bound, the typed failure fraction since
  the last probe (shed/timeout/failed/engine_restart counter deltas),
  the SLO fast-window burn rate (``obs/slo.py``) and the staleness of
  the stats snapshot.  ``HealthMonitor`` tracks the counter deltas
  between probes;
- **circuit breaker** (``CircuitBreaker``): closed -> open on
  ``failures`` consecutive typed failures or a health score under
  ``health_floor``; open -> half-open after a seeded-jitter exponential
  backoff; half-open admits exactly one probe request, whose success
  closes the breaker and whose failure re-opens it with the next
  backoff step.  The jitter is drawn from ``random.Random(seed)``, so
  the backoff sequence is deterministic.

``parse_breaker`` is the ``--breaker`` flag DSL.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Dict, Optional

# health-score weights: the penalty budget each signal can spend.
# They sum to 1.0 so a replica maxing every signal scores exactly 0.
W_QUEUE = 0.25      # pending queue depth / its bound
W_BURN = 0.25       # SLO fast-window burn rate / BURN_SCALE
W_FAILURE = 0.30    # typed-failure fraction of terminals since probe
W_STALE = 0.20      # stats-snapshot staleness / STALE_SCALE_S
BURN_SCALE = 2.0    # burn rate at which the burn penalty saturates
STALE_SCALE_S = 10.0  # staleness at which the stale penalty saturates


def _unit(x: float) -> float:
    return min(1.0, max(0.0, float(x)))


def health_score(queued: int = 0, queue_limit: int = 0,
                 failure_delta: int = 0, ok_delta: int = 0,
                 burn_rate: Optional[float] = None,
                 staleness_s: float = 0.0) -> float:
    """One replica's health in [0, 1] — 1.0 = idle and clean, 0.0 =
    every signal saturated.  Closed form:

        score = 1 - W_QUEUE   * min(1, queued / queue_limit)
                  - W_BURN    * min(1, burn_rate / BURN_SCALE)
                  - W_FAILURE * failure_delta / max(1, failure_delta
                                                       + ok_delta)
                  - W_STALE   * min(1, staleness_s / STALE_SCALE_S)

    ``queue_limit`` 0 (unbounded) contributes no queue penalty — an
    unbounded queue has no fullness fraction; ``burn_rate`` None (no
    SLO data yet) contributes no burn penalty.  ``failure_delta`` /
    ``ok_delta`` are counter DELTAS since the last probe: sheds,
    timeouts, faileds and engine restarts vs completions."""
    score = 1.0
    if queue_limit > 0:
        score -= W_QUEUE * _unit(queued / queue_limit)
    if burn_rate is not None:
        score -= W_BURN * _unit(burn_rate / BURN_SCALE)
    total = failure_delta + ok_delta
    if failure_delta > 0:
        score -= W_FAILURE * _unit(failure_delta / max(1, total))
    if staleness_s > 0:
        score -= W_STALE * _unit(staleness_s / STALE_SCALE_S)
    return round(_unit(score), 6)


class HealthMonitor:
    """Turns a stream of ``DecodeEngine.stats()`` snapshots into
    health scores by tracking the typed-failure counter deltas
    between probes (the counters are lifetime totals; health is about
    what happened RECENTLY)."""

    _FAIL_KEYS = ("shed_total", "timeout_total", "failed_total",
                  "engine_restarts_total")

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._prev: Dict[str, int] = {}
        self._prev_t: Optional[float] = None
        self.score = 1.0

    def update(self, stats: Dict[str, Any],
               burn_rate: Optional[float] = None,
               now: Optional[float] = None) -> float:
        """Fold one stats snapshot; returns the new score.  ``now``
        overrides the clock (tests drive it deterministically)."""
        if now is None:
            now = self._clock()
        fails = sum(int(stats.get(k) or 0) for k in self._FAIL_KEYS)
        oks = int(stats.get("completed_total") or 0)
        d_fail = fails - self._prev.get("fail", 0)
        d_ok = oks - self._prev.get("ok", 0)
        stale = (now - self._prev_t) if self._prev_t is not None else 0.0
        self._prev = {"fail": fails, "ok": oks}
        self._prev_t = now
        self.score = health_score(
            queued=int(stats.get("queued") or 0),
            queue_limit=int(stats.get("queue_limit") or 0),
            failure_delta=max(0, d_fail), ok_delta=max(0, d_ok),
            burn_rate=burn_rate,
            staleness_s=max(0.0, stale) if self._prev_t else 0.0)
        return self.score


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Circuit-breaker knobs.  ``failures`` consecutive typed
    failures (or a health score under ``health_floor``) trip the
    breaker; trip ``n`` (1-based) backs off
    ``min(cap_s, base_s * 2**(n-1)) * (1 + jitter * u_n)`` with
    ``u_n`` the n-th draw of ``random.Random(seed)`` — seeded, so
    the sequence is exact in tests and de-synchronized across
    replicas in production (each replica's breaker gets its own
    seed)."""

    failures: int = 3
    base_s: float = 0.2
    cap_s: float = 5.0
    jitter: float = 0.1
    health_floor: float = 0.2
    seed: int = 0

    def __post_init__(self):
        if self.failures < 1:
            raise ValueError(
                f"failures={self.failures} must be >= 1")
        if self.base_s <= 0:
            raise ValueError(f"base_s={self.base_s} must be > 0")
        if self.cap_s < self.base_s:
            raise ValueError(
                f"cap_s={self.cap_s} must be >= base_s={self.base_s}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(
                f"jitter={self.jitter} must be in [0, 1]")
        if not 0.0 <= self.health_floor < 1.0:
            raise ValueError(
                f"health_floor={self.health_floor} must be in [0, 1)")


def parse_breaker(text: str) -> BreakerPolicy:
    """Parse the ``--breaker`` DSL: empty or ``on`` = the documented
    defaults; otherwise comma-separated ``key=value`` over failures /
    base / cap / jitter / floor / seed (e.g.
    ``failures=5,base=0.5,cap=10``).  Raises ValueError on an unknown
    key or malformed value, naming the offending part (the
    parse_brownout contract)."""
    text = (text or "").strip()
    if not text or text == "on":
        return BreakerPolicy()
    names = {"failures": ("failures", int),
             "base": ("base_s", float),
             "cap": ("cap_s", float),
             "jitter": ("jitter", float),
             "floor": ("health_floor", float),
             "seed": ("seed", int)}
    kw = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in names:
            raise ValueError(
                f"bad --breaker part {part!r} (want key=value with "
                f"key one of {sorted(names)}, or 'on', or empty)")
        field, typ = names[key]
        try:
            kw[field] = typ(val)
        except ValueError:
            raise ValueError(f"bad --breaker value in {part!r}")
    return BreakerPolicy(**kw)


class CircuitBreaker:
    """closed → open → half-open → closed, deterministically.

    - **closed**: requests flow; ``record_failure`` counts
      consecutive typed failures — at ``policy.failures`` (or when
      ``note_health`` reports a score under ``health_floor``) the
      breaker OPENS and arms the trip's backoff;
    - **open**: ``allow()`` is False until the backoff elapses, then
      the breaker moves to half-open;
    - **half-open**: ``allow()`` grants exactly ONE probe (further
      calls are refused while it is outstanding);
      ``record_success`` closes the breaker and resets the trip
      ordinal, ``record_failure`` re-opens it with the NEXT backoff
      step.

    The clock is injected (``time.monotonic`` by default) so the
    state machine is test-drivable without sleeping."""

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 clock=time.monotonic):
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._rng = random.Random(self.policy.seed)
        self.state = "closed"
        self.consecutive_failures = 0
        self.trips = 0              # lifetime trip count (stats)
        self._trip_ordinal = 0      # resets on close: backoff restarts
        self._retry_at: Optional[float] = None
        self._probe_out = False
        self.last_reason: Optional[str] = None

    def backoff_s(self) -> float:
        """The CURRENT trip's backoff: exponential in the trip
        ordinal, capped, with one seeded jitter draw per trip."""
        p = self.policy
        base = min(p.cap_s, p.base_s * (2 ** (self._trip_ordinal - 1)))
        return round(base * (1.0 + p.jitter * self._rng.random()), 6)

    def _open(self, reason: str, now: Optional[float] = None) -> None:
        self._trip_ordinal += 1
        self.trips += 1
        self.state = "open"
        self.last_reason = reason
        self._probe_out = False
        self._retry_at = (self._clock() if now is None else now) \
            + self.backoff_s()

    def allow(self, now: Optional[float] = None) -> bool:
        """May a request be routed here now?  Transitions open →
        half-open as a side effect once the backoff has elapsed; in
        half-open, True exactly once (the single probe)."""
        if self.state == "closed":
            return True
        if now is None:
            now = self._clock()
        if self.state == "open":
            if self._retry_at is not None and now >= self._retry_at:
                self.state = "half_open"
                self._probe_out = True
                return True
            return False
        # half-open: one probe outstanding
        if not self._probe_out:
            self._probe_out = True
            return True
        return False

    def would_allow(self, now: Optional[float] = None) -> bool:
        """A NON-consuming admittability peek: placement ranks
        replicas with this; only the actual dispatch calls ``allow()``
        (which consumes the half-open probe).  No state transitions —
        an open breaker whose backoff has elapsed reads True here but
        moves to half-open only when ``allow()`` grants the probe."""
        if self.state == "closed":
            return True
        if now is None:
            now = self._clock()
        if self.state == "open":
            return self._retry_at is not None and now >= self._retry_at
        return not self._probe_out

    def abort_probe(self) -> None:
        """The granted half-open probe was never actually issued (the
        replica shed it at the door, so nothing will succeed or fail):
        hand the slot back, or the breaker waits forever on a probe
        that does not exist."""
        if self.state == "half_open":
            self._probe_out = False

    def record_success(self) -> None:
        """A routed request reached a clean terminal: close (from any
        state) and reset both the consecutive-failure count and the
        backoff ladder."""
        self.state = "closed"
        self.consecutive_failures = 0
        self._trip_ordinal = 0
        self._retry_at = None
        self._probe_out = False

    def record_failure(self, reason: str = "typed failure",
                       now: Optional[float] = None) -> None:
        """A routed request hit a typed failed terminal (or the
        replica refused as dead).  In half-open this re-opens
        immediately; closed opens at the consecutive threshold."""
        if self.state == "half_open":
            self._open(reason, now=now)
            return
        if self.state == "open":
            return
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.policy.failures:
            self._open(reason, now=now)

    def note_health(self, score: float,
                    now: Optional[float] = None) -> None:
        """Health collapse trips a CLOSED breaker without waiting for
        ``failures`` individual requests to burn."""
        if self.state == "closed" and score < self.policy.health_floor:
            self._open(f"health collapse ({score:g} < "
                       f"{self.policy.health_floor:g})", now=now)

    def describe(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "trips": self.trips,
            "retry_at": self._retry_at,
            "last_reason": self.last_reason,
        }
