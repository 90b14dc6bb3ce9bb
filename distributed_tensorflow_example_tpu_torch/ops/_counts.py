"""Launch counts of the port's kernel wrappers.

Each wrapper module (``fused``, ``flash_attention``) registers its
wrappers here when it is imported; a wrapper raises its ``launches``
by one (``count``) each time it launches its kernel.  The counts are
process-wide: engines of a fleet launching from their own threads add
to the same counts, under one lock, so a run reads the fleet's total.
``launch_counts`` and ``reset_launch_counts`` read and zero every
registered wrapper's count, so a run can show that its main path went
through the kernels.  A CUDA graph's replay runs no Python, so the
code that replays one raises the counts by the launches its capture
recorded (``add_launches``).

While the trainer's graph dump records a step (``utils/graph.py``), a
recorder is set (``set_recorder``): ``count`` hands it the wrapper's
name, its tensors and its launch plan at each launch, and each
wrapper's CPU branch calls ``plain`` to say its plain version ran.
The kernels go through ctypes, never through the dispatcher, so these
calls are the dump's only view of them.
Importing ``ops`` imports both wrapper modules, so the registry is
complete whichever of them a caller imports.
"""

from __future__ import annotations

import threading

_WRAPPERS: list = []
_lock = threading.Lock()
# the graph dump's recorder while it records a step, else None
_recorder = None


def register(*wrappers) -> None:
    """Give each wrapper a ``launches`` count of 0 and list it."""
    for w in wrappers:
        w.launches = 0
        _WRAPPERS.append(w)


def count(wrapper, *tensors, plan=None) -> None:
    """Raise ``wrapper``'s count by one (the one call site per launch);
    ``tensors`` and ``plan`` (the launch's inputs and plan) go to the
    recorder, when one is set."""
    with _lock:
        wrapper.launches += 1
    rec = _recorder
    if rec is not None:
        rec(wrapper.__name__, tensors, plan, True)


def plain(wrapper, *tensors) -> None:
    """Tell the recorder, when one is set, that ``wrapper`` ran its
    plain version on ``tensors`` (CPU tensors: no launch, no count)."""
    rec = _recorder
    if rec is not None:
        rec(wrapper.__name__, tensors, None, False)


def set_recorder(fn):
    """Set the recorder (None: none); returns the one it replaces."""
    global _recorder
    with _lock:
        old, _recorder = _recorder, fn
    return old


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every registered wrapper."""
    with _lock:
        return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    with _lock:
        for w in _WRAPPERS:
            w.launches = 0


def add_launches(counts: dict) -> None:
    """Raise each named wrapper's count by its number in ``counts`` (a
    ``launch_counts``-shaped difference; a negative number takes back
    what a capture counted without launching)."""
    by_name = {w.__name__: w for w in _WRAPPERS}
    with _lock:
        for name, n in counts.items():
            by_name[name].launches += n
