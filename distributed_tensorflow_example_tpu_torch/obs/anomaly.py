"""In-step anomaly detection: the host half of ``--on_anomaly`` — the
port's copy of the JAX package's ``obs/anomaly.py``.

The device half lives in ``parallel/step.py``:
``make_sync_step_body(..., with_anomaly=True)`` returns, beside cost and
accuracy, ``{"flag": bool tensor, "counts": [n_leaves] int32}`` — one
"this step produced a non-finite loss or gradient" bit and the per-leaf
non-finite element counts, computed on the card.  Under
``--on_anomaly=skip`` the step also masks the update itself (params and
optimizer slots keep their old values on a flagged step, with
``torch.where`` on the flag, inside the CUDA graph too), so one NaN
batch cannot poison the run before the host notices.

This module is the host side:

- ``LossWatchdog`` — a rolling loss-EMA divergence detector: flags a
  non-finite loss immediately, and (after a warmup) a loss more than
  ``factor``x the EMA — the "diverging but not yet NaN" case a
  non-finite check misses;
- ``AnomalyPolicy`` — the ``--on_anomaly={halt,dump,skip}`` policy
  with skipped-step accounting and per-leaf blame.  Every anomaly is
  recorded into the flight recorder (``obs/flight.py``) and the metrics
  stream; ``halt`` then raises ``AnomalyError`` (the crash path dumps
  the flight record), ``dump`` writes a flight dump and continues,
  ``skip`` counts on the device-masked step.

The host checks ride fetches the loop already performs (a queue drained
no faster than the dispatch window, and window boundaries), so
detection lags by at most that depth and the feature costs nothing when
off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

POLICIES = ("", "halt", "dump", "skip")


class AnomalyError(RuntimeError):
    """--on_anomaly=halt: raised after the anomaly is recorded; the
    train loop's crash path turns it into a flight dump."""


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


class LossWatchdog:
    """Rolling loss-EMA divergence detector.

    ``observe(step, loss)`` -> reason string or None. A non-finite
    loss flags immediately ("nonfinite_loss"); once ``warmup`` finite
    losses have seeded the EMA, a loss exceeding ``factor * ema``
    (with an absolute floor ``min_ema`` so a near-zero EMA cannot
    flag noise) flags "divergence". The EMA only absorbs NON-flagged
    losses, so a blowup cannot drag its own baseline up.
    """

    def __init__(self, factor: float = 10.0, beta: float = 0.98,
                 warmup: int = 20, min_ema: float = 1e-3):
        if factor <= 1.0:
            raise ValueError(f"factor={factor} must be > 1")
        self.factor = float(factor)
        self.beta = float(beta)
        self.warmup = int(warmup)
        self.min_ema = float(min_ema)
        self.ema: Optional[float] = None
        self.seen = 0

    def observe(self, step: int, loss) -> Optional[str]:
        if loss is None:
            return None
        if not _finite(loss):
            return "nonfinite_loss"
        loss = float(loss)
        if self.ema is not None and self.seen >= self.warmup:
            if loss > self.factor * max(self.ema, self.min_ema):
                return "divergence"
        self.ema = (loss if self.ema is None
                    else self.beta * self.ema + (1.0 - self.beta) * loss)
        self.seen += 1
        return None


class AnomalyPolicy:
    """--on_anomaly bookkeeping + reaction.

    ``on_step`` consumes one step's fetched signals (host-side loss
    and, on the host path, the step's flag/counts); ``on_epoch``
    consumes a fast-path epoch's already-returned cost array
    post-hoc. Both record every anomaly (flight + metrics event) and
    then apply the policy.
    """

    def __init__(self, mode: str, leaf_names: Optional[Sequence[str]] = None,
                 flight=None, mlogger=None,
                 watchdog: Optional[LossWatchdog] = None,
                 max_dump_writes: int = 8, max_event_logs: int = 64):
        if mode not in POLICIES or not mode:
            raise ValueError(
                f"on_anomaly={mode!r}: expected one of "
                f"{[p for p in POLICIES if p]}")
        self.mode = mode
        self.leaf_names = list(leaf_names) if leaf_names else None
        self.flight = flight
        self.mlogger = mlogger
        self.watchdog = watchdog
        self.anomalies = 0
        self.skipped_steps = 0
        self._dump_writes = 0
        self._max_dump_writes = int(max_dump_writes)
        self._max_event_logs = int(max_event_logs)

    # -- blame -------------------------------------------------------------

    def blame(self, counts) -> Dict[str, int]:
        """{leaf_name: non-finite element count} for flagged leaves."""
        if counts is None:
            return {}
        out: Dict[str, int] = {}
        for i, c in enumerate(counts):
            c = int(c)
            if c:
                name = (self.leaf_names[i]
                        if self.leaf_names and i < len(self.leaf_names)
                        else f"leaf[{i}]")
                out[name] = c
        return out

    # -- reaction ----------------------------------------------------------

    def _react(self, step: int, reasons: List[str], loss,
               blame: Dict[str, int], skipped: int = 0) -> None:
        self.anomalies += 1
        self.skipped_steps += skipped
        if loss is not None:
            # strict-JSON-safe: the record lands in the metrics jsonl
            # (whose consumers are standards parsers) as well as the
            # flight dump — a bare NaN literal would break the former
            loss = float(loss)
            if not math.isfinite(loss):
                loss = repr(loss)
        record = {
            "step": int(step),
            "reasons": reasons,
            "loss": loss,
            "blame": blame,
            "policy": self.mode,
            "skipped_steps_total": self.skipped_steps,
        }
        if self.flight is not None:
            self.flight.record_anomaly(**record)
        if self.mlogger is not None and self.anomalies <= self._max_event_logs:
            # bounded: a skip-mode run limping through a long NaN tail
            # must not flood the metrics stream (the flight ring and
            # the counters keep the full accounting)
            self.mlogger.log_event("anomaly", **record)
        if self.mode == "dump" and self.flight is not None:
            # bounded: a long NaN tail must not turn into an I/O storm
            if self._dump_writes < self._max_dump_writes:
                self._dump_writes += 1
                self.flight.dump("anomaly")
        if self.mode == "halt":
            raise AnomalyError(
                f"anomaly at step {step}: {', '.join(reasons)} "
                f"(loss={loss}, blame={blame or 'n/a'}); halted by "
                f"--on_anomaly=halt")

    def on_step(self, step: int, loss=None, flagged: Optional[bool] = None,
                counts=None) -> bool:
        """One host-visible step; True if it was anomalous. ``flagged``
        /``counts`` are the step's outputs when available."""
        reasons: List[str] = []
        blame: Dict[str, int] = {}
        if flagged:
            blame = self.blame(counts)
            reasons.append("nonfinite_grads" if blame else "nonfinite_loss")
        if self.watchdog is not None:
            r = self.watchdog.observe(step, loss)
            if r and r not in reasons:
                # a device-flagged nonfinite loss is already reason'd
                if not (r == "nonfinite_loss" and flagged):
                    reasons.append(r)
        if not reasons:
            return False
        self._react(step, reasons, loss, blame,
                    skipped=(1 if self.mode == "skip" and flagged else 0))
        return True

    def on_epoch(self, epoch: int, costs, base_step: int = 0) -> int:
        """Fast-path post-hoc check over one epoch's returned per-step
        cost array; returns the number of anomalous steps. Under
        ``skip`` the step already masked those updates on the card — the
        non-finite cost entries are the skipped-step accounting.

        Known limit: the fast path returns only costs, so a step whose
        GRADIENTS went non-finite while its loss stayed finite is
        masked on-device but invisible here (uncounted, and halt/dump
        don't fire). The host loop fetches the step's flag and has
        exact accounting — use it when that distinction matters."""
        import numpy as np

        costs = np.asarray(costs)
        bad_idx = np.nonzero(~np.isfinite(costs))[0]
        for i in bad_idx:
            self._react(base_step + int(i) + 1, ["nonfinite_loss"],
                        float(costs[i]) if costs[i] == costs[i] else None,
                        {}, skipped=(1 if self.mode == "skip" else 0))
        if self.watchdog is not None:
            for i in np.nonzero(np.isfinite(costs))[0]:
                r = self.watchdog.observe(base_step + int(i) + 1,
                                          float(costs[i]))
                if r:
                    self._react(base_step + int(i) + 1, [r],
                                float(costs[i]), {})
        return int(bad_idx.size)

    def summary(self) -> Dict[str, int]:
        return {"anomalies": self.anomalies,
                "skipped_steps": self.skipped_steps}
