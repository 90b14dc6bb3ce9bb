"""SIGTERM/SIGINT-safe final snapshots (the port's copy of the JAX
package's ``resilience/signals.py``).

Fleets announce preemption with SIGTERM and give the process a grace
window.  ``PreemptionHandler`` turns that window into a durable
checkpoint:

- the handler does the async-signal-safe minimum: record the signal,
  nudge the write-behind thread (``CheckpointWriter.flush_async``: the
  newest host snapshot already captured reaches disk even if the main
  thread never gets another safe point), and chain to any previous
  handler.  It makes no CUDA call;
- the train loop polls :attr:`requested` at its per-step safe point,
  lands one final consistent snapshot at the exact current step through
  the normal submit path, drains the writer, and raises
  :class:`Preempted` — a ``SystemExit`` carrying the conventional
  ``128 + signum`` exit code, so a supervisor tells preemption from a
  crash.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional


def install_chained(signum, handler):
    """Install ``handler`` for ``signum`` and return the previous handler
    (to chain to and to restore later), or None off the main thread or
    where the platform lacks the signal."""
    try:
        return signal.signal(signum, handler)
    except (ValueError, OSError, AttributeError):
        return None


def restore_handler(signum, prev) -> None:
    """Undo ``install_chained`` (best-effort; SIG_DFL when the previous
    handler is unknown)."""
    try:
        signal.signal(signum, prev or signal.SIG_DFL)
    except (ValueError, OSError, AttributeError):
        pass


class Preempted(SystemExit):
    """Raised by the train loop at the safe point after a preemption
    signal; ``code`` is the conventional 128 + signum."""

    def __init__(self, signum: int):
        super().__init__(128 + int(signum))
        self.signum = int(signum)


class PreemptionHandler:
    """Chained SIGTERM/SIGINT handler + the safe-point flag."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)
    # repeat-SIGINT escalation debounce: same-burst duplicates (a
    # supervisor signalling the process group) stay graceful; a human
    # double-Ctrl-C comfortably exceeds this
    ESCALATE_S = 1.0

    def __init__(self, writer=None,
                 on_signal: Optional[Callable[[int], None]] = None):
        """``writer``: a CheckpointWriter whose pending snapshot the
        handler flushes. ``on_signal(signum)`` runs inside the handler
        — keep it async-signal-safe (the loop uses it to stamp the
        preempt narration; file appends are acceptable there because
        the alternative is losing the event entirely)."""
        self.writer = writer
        self.on_signal = on_signal
        self.signum: Optional[int] = None
        self.signal_t: Optional[float] = None
        self._prev = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self.signum is not None

    def install(self) -> None:
        if self._installed:
            return
        for sig in self.SIGNALS:
            self._prev[sig] = install_chained(sig, self._on_signal)
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig in self.SIGNALS:
            restore_handler(sig, self._prev.get(sig))
        self._prev = {}
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        first = self.signum is None
        if first:
            self.signum = int(signum)
            self.signal_t = time.time()
        if self.writer is not None:
            self.writer.flush_async()
        if first and self.on_signal is not None:
            try:
                self.on_signal(int(signum))
            except Exception:
                pass  # narration must not mask the shutdown
        prev = self._prev.get(signum)
        if prev is getattr(signal, "default_int_handler", None):
            # Python's default SIGINT handler raises KeyboardInterrupt
            # AT the interrupted bytecode — chaining it on the first
            # Ctrl-C would skip the safe point and lose the final
            # snapshot. First signal: graceful (the loop's safe point
            # takes it from here). A REPEAT signal past the debounce
            # escalates — the operator asked twice, interrupt NOW.
            # (The debounce matters: supervisors signal the process
            # GROUP, so one preemption can deliver the same signal
            # multiple times within microseconds — observed live with
            # `timeout`-wrapped runs; that burst must not turn the
            # graceful path into a mid-bytecode interrupt.)
            if first or (time.time()
                         - (self.signal_t or 0.0)) < self.ESCALATE_S:
                return
            raise KeyboardInterrupt
        if callable(prev):
            prev(signum, frame)

    def check(self) -> None:
        """The safe-point poll: raise :class:`Preempted` when a signal
        arrived. The loop calls this AFTER landing its final snapshot."""
        if self.signum is not None:
            raise Preempted(self.signum)

    def signal_name(self) -> Optional[str]:
        if self.signum is None:
            return None
        try:
            return signal.Signals(self.signum).name
        except ValueError:
            return str(self.signum)
