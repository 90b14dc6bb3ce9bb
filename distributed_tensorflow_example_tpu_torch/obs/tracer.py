"""Windowed profiler capture (``--profile_steps``) and trace scopes on
``torch.profiler`` — the port's counterpart of the JAX package's
``obs/tracer.py``.

A whole-run trace skews the numbers it reports and grows without bound;
a windowed capture starts right before an exact step and stops a fixed
number of steps later, with the host phases annotated inside so the
timeline lines up with the metrics split (``obs/metrics.py`` buckets).

``WindowedTracer`` owns the lifecycle:

- ``--profile_steps START:COUNT`` (``parse_profile_steps``) captures the
  steps ``[START, START+COUNT)`` on the host path; the fast path traces
  at its call granularity (``on_range``): the epochs, or the run,
  overlapping the window;
- the whole-run ``--profile`` rides the same object (``begin_run``), so
  the loop's ``finally`` calling ``stop()`` ends a capture that a crash
  interrupted;
- each capture is written as a Chrome trace,
  ``<logs_path>/profile/trace.<k>.json`` (``chrome://tracing``,
  Perfetto), before the window counts as captured;
- ``step_annotation``/``annotate`` open a ``torch.profiler.
  record_function`` range and, on the card, a ``torch.cuda.nvtx`` range
  of the same name while a capture is open, and do nothing otherwise.
  The names come from ``obs/buckets.TRACE_SCOPES`` (the metrics buckets
  plus ``eval`` and ``checkpoint``).

``scope`` is JAX's ``jax.named_scope`` for the port: the model, the
engine and the local-SGD round name their regions (``obs/buckets.
NAMED_SCOPES``: ``ln``, ``moe_dispatch``, ``moe_expert``, ``pp_comm``,
``prefill``, ``decode``, ``sampling``, ``outer_sync``, ``quant``) with
the same two ranges, opened only while a profiler captures (any
capture, windowed or not), so a capture attributes them as JAX's does.
A JAX scope names the transposed operators too; a torch range covers
the operators issued inside it, so autograd's backward runs outside
it.

The trace's kernel rows come from CUPTI: on the H100 the kernels inside
the MLP's CUDA graph replays appear by name, as the transformer's eager
epoch's do (the flash forward, dq and dk/dv among them).

The profiler backend is injected (``profiler=``, default
``TorchProfiler``), so the windowing contract — start and stop exactly
once per window, annotations nest — is testable without a trace.  JAX's
on-demand profiler server (``--profile_port``) has no torch counterpart;
the trainer refuses that flag.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Tuple

import torch

from .buckets import NAMED_SCOPES, TRACE_SCOPES


def parse_profile_steps(s: str) -> Optional[Tuple[int, int]]:
    """``"START:COUNT"`` -> ``(start, count)``; ``""``/None -> None.
    start is the 0-based global step index of the first traced step."""
    if not s:
        return None
    parts = str(s).split(":")
    if len(parts) != 2:
        raise ValueError(
            f"profile_steps={s!r}: expected 'START:COUNT' (e.g. '500:20')")
    try:
        start, count = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"profile_steps={s!r}: START and COUNT must be integers")
    if start < 0:
        raise ValueError(f"profile_steps={s!r}: START must be >= 0")
    if count < 1:
        raise ValueError(f"profile_steps={s!r}: COUNT must be >= 1")
    return start, count


@contextlib.contextmanager
def _named_range(name: str):
    """A ``record_function`` range in the profiler's trace and, on the
    card, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# the scope's ranges outside a profiler capture: none (a range costs
# microseconds of host time, and a decode tick opens dozens: PERF.md §6)
_NO_RANGE = contextlib.nullcontext()


def scope(name: str):
    """A region of ``NAMED_SCOPES`` (``jax.named_scope(name)``) around
    what runs inside: while a profiler captures, ``_named_range``'s
    ``record_function`` range and, on the card, NVTX range; otherwise
    nothing, as ``annotate`` opens a range only while a capture is open
    (a tool that reads NVTX sees them in a ``--profile`` or
    ``--profile_steps`` window).  A name outside ``NAMED_SCOPES`` raises
    ``ValueError``, as ``annotate`` refuses one outside
    ``TRACE_SCOPES``."""
    if name not in NAMED_SCOPES:
        raise ValueError(f"unknown named scope {name!r}: expected one of "
                         f"{NAMED_SCOPES}")
    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return _named_range(name)


class TorchProfiler:
    """The trace backend: ``torch.profiler.profile`` over the host and,
    with a card, its kernels; each stopped capture is exported as a
    Chrome trace into the directory its start named."""

    def __init__(self):
        self._prof = None
        self._dir = None
        self.trace_paths: List[str] = []

    def start_trace(self, trace_dir: str) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof, self._dir = prof, trace_dir

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self._dir, f"trace.{len(self.trace_paths)}.json")
        prof.export_chrome_trace(path)
        self.trace_paths.append(path)

    def StepTraceAnnotation(self, name: str, step_num=None):
        return _named_range(f"{name}#{step_num}")

    def TraceAnnotation(self, name: str):
        return _named_range(name)


class WindowedTracer:
    """Programmatic ``torch.profiler`` capture around exact steps.

    One instance per process; ``enabled=False`` (not the chief, or no
    profiling flag) makes every method a no-op returning
    ``nullcontext``: the off path costs one attribute check.
    """

    def __init__(self, logs_path: str,
                 window: Optional[Tuple[int, int]] = None,
                 whole_run: bool = False, enabled: bool = True,
                 profiler=None):
        self.trace_dir = os.path.join(logs_path, "profile")
        self.window = window
        self.whole_run = bool(whole_run) and window is None
        self.enabled = bool(enabled) and (window is not None or whole_run)
        self._profiler = profiler
        self._active = False
        self._finished = False
        self.windows_captured = 0

    def _prof(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    # -- capture lifecycle ------------------------------------------------

    def _start(self) -> None:
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof().start_trace(self.trace_dir)
            self._active = True
        except Exception as e:  # tracing must never take down training
            print(f"NOTE: profiler start_trace failed: {e}")
            self.enabled = False

    def _stop(self) -> None:
        # the trace is written before the window counts as captured
        try:
            self._prof().stop_trace()
            self.windows_captured += 1
        except Exception as e:
            print(f"NOTE: profiler stop_trace failed: {e}")
        self._active = False

    def begin_run(self) -> None:
        """Whole-run (``--profile``) mode: start now.  Windowed mode
        waits for its step."""
        if self.enabled and self.whole_run and not self._active:
            self._start()

    def boundary(self, step: int) -> bool:
        """True when ``on_step(step)`` will open or close the window.
        The host loop, which runs up to its dispatch window ahead of the
        card, must wait for the newest step in flight before crossing a
        boundary, or the capture would hold the device work of earlier
        steps.  Two waits a run, at the window's edges."""
        if (not self.enabled or self._finished or self.whole_run
                or self.window is None):
            return False
        start, count = self.window
        if self._active:
            return step >= start + count
        return start <= step < start + count

    def on_step(self, step: int) -> None:
        """Host-path hook, called once per step (0-based global id of the
        step about to run): opens the window at START, closes it before
        step START+COUNT runs — exactly COUNT steps."""
        if not self.enabled or self._finished or self.whole_run:
            return
        start, count = self.window
        if self._active:
            if step >= start + count:
                self._stop()
                self._finished = True
        elif start <= step < start + count:
            self._start()

    def on_range(self, lo: int, hi: int) -> None:
        """Fast-path hook: the call about to run covers steps ``[lo,
        hi)``.  Start when it overlaps the window, stop once past it."""
        if not self.enabled or self._finished or self.whole_run:
            return
        start, count = self.window
        end = start + count
        if self._active:
            if lo >= end:
                self._stop()
                self._finished = True
        elif lo < end and hi > start:
            self._start()

    def stop(self) -> None:
        """Final stop: idempotent and exception-safe — the loop's
        ``finally`` calls this, so a crash never leaves a capture
        open."""
        if self._active:
            self._stop()
        self._finished = True

    @property
    def active(self) -> bool:
        return self._active

    # -- annotations ------------------------------------------------------

    def step_annotation(self, step: int):
        """A ``train#<step>`` range around one train step, only while a
        capture is open."""
        if not self._active:
            return contextlib.nullcontext()
        return self._prof().StepTraceAnnotation("train", step_num=step)

    def annotate(self, name: str):
        """A named range from ``TRACE_SCOPES``, only while a capture is
        open (the name is checked first, so a drifted scope name fails
        in any run)."""
        if name not in TRACE_SCOPES:
            raise ValueError(f"unknown trace scope {name!r}: expected "
                             f"one of {TRACE_SCOPES}")
        if not self._active:
            return contextlib.nullcontext()
        return self._prof().TraceAnnotation(name)
