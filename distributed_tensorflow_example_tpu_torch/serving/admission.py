"""Admission control and graceful degradation — pure Python.

The port's own copy of what its engine and front door use from the
JAX package's ``serving/admission.py``:

- **load shedding** (``ShedError``): the engine bounds its pending
  queue (``max_queue``); a submit past the bound raises this typed
  rejection, which ``POST /generate`` maps to ``503`` with a
  ``Retry-After`` hint;
- **brownout** (``BrownoutPolicy``): when KV page-pool occupancy (or
  an SLO burn rate, where one is measured) crosses its threshold, new
  admissions are degraded instead of refused — ``max_new_tokens``
  clamped, admission width per tick capped — with hysteresis
  (``occupancy_lo``) so the policy does not flap.
``parse_brownout`` is the ``--brownout`` flag DSL.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def retry_after_hint(p50_ms: Optional[float]) -> float:
    """The Retry-After hint a shed carries: the p50 request latency in
    seconds when one is known, floored at 1 s."""
    return round(max(1.0, (p50_ms or 0.0) / 1e3), 3)


def retry_after_header(retry_after_s: float) -> int:
    """The HTTP ``Retry-After`` header value for a hint in seconds:
    integer-seconds ceiling, floored at 1 (rounding down would invite
    the client back before the queue slot has drained)."""
    return max(1, int(math.ceil(float(retry_after_s))))


class ShedError(RuntimeError):
    """A request refused by admission control (bounded queue); the
    HTTP front door maps it to 503 + ``Retry-After``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 rid: Optional[int] = None):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.rid = rid


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """Graceful-degradation thresholds.  Activation: page-pool
    occupancy >= ``occupancy_hi`` OR burn rate >= ``burn_hi``;
    deactivation needs occupancy under ``occupancy_lo`` AND burn under
    ``burn_hi``."""

    occupancy_hi: float = 0.90
    occupancy_lo: float = 0.75
    burn_hi: float = 2.0
    clamp_new_tokens: int = 8   # max_new_tokens cap for NEW admissions
    admit_per_tick: int = 1     # admission width cap while active

    def __post_init__(self):
        if not 0.0 < self.occupancy_hi <= 1.0:
            raise ValueError(
                f"occupancy_hi={self.occupancy_hi} must be in (0, 1]")
        if not 0.0 <= self.occupancy_lo <= self.occupancy_hi:
            raise ValueError(
                f"occupancy_lo={self.occupancy_lo} must be in "
                f"[0, occupancy_hi]")
        if self.burn_hi <= 0:
            raise ValueError(f"burn_hi={self.burn_hi} must be > 0")
        if self.clamp_new_tokens < 1:
            raise ValueError(
                f"clamp_new_tokens={self.clamp_new_tokens} must be "
                f">= 1")
        if self.admit_per_tick < 1:
            raise ValueError(
                f"admit_per_tick={self.admit_per_tick} must be >= 1")

    def update(self, active: bool, occupancy: float,
               burn_rate: Optional[float]) -> bool:
        """One hysteresis transition: the next ``active`` state given
        the current observations (``burn_rate`` None = no SLO data —
        only occupancy decides)."""
        burning = burn_rate is not None and burn_rate >= self.burn_hi
        if active:
            return occupancy >= self.occupancy_lo or burning
        return occupancy >= self.occupancy_hi or burning


def parse_brownout(text: str) -> Optional[BrownoutPolicy]:
    """Parse the ``--brownout`` DSL: empty = disabled (None); ``on``
    = the defaults; otherwise comma-separated ``key=value`` over occ /
    occ_lo / burn / clamp / admit (e.g. ``occ=0.85,clamp=4,admit=1``).
    Raises ValueError naming the offending part."""
    text = (text or "").strip()
    if not text:
        return None
    if text == "on":
        return BrownoutPolicy()
    kw = {}
    names = {"occ": ("occupancy_hi", float),
             "occ_lo": ("occupancy_lo", float),
             "burn": ("burn_hi", float),
             "clamp": ("clamp_new_tokens", int),
             "admit": ("admit_per_tick", int)}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in names:
            raise ValueError(
                f"bad --brownout part {part!r} (want key=value with "
                f"key one of {sorted(names)}, or 'on', or empty)")
        field, typ = names[key]
        try:
            kw[field] = typ(val)
        except ValueError:
            raise ValueError(f"bad --brownout value in {part!r}")
    # a lowered occ that undercuts the default lo scales lo down with it
    if "occupancy_hi" in kw and "occupancy_lo" not in kw \
            and kw["occupancy_hi"] < BrownoutPolicy.occupancy_lo:
        kw["occupancy_lo"] = round(kw["occupancy_hi"] * 5 / 6, 6)
    return BrownoutPolicy(**kw)
