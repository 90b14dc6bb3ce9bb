"""Launch counts of the port's kernel wrappers.

Each wrapper module (``fused``, ``flash_attention``) registers its
wrappers here when it is imported; a wrapper raises its ``launches``
by one each time it launches its kernel.  ``launch_counts`` and
``reset_launch_counts`` read and zero every registered wrapper's count,
so a run can show that its main path went through the kernels.
Importing ``ops`` imports both wrapper modules, so the registry is
complete whichever of them a caller imports.
"""

from __future__ import annotations

_WRAPPERS: list = []


def register(*wrappers) -> None:
    """Give each wrapper a ``launches`` count of 0 and list it."""
    for w in wrappers:
        w.launches = 0
        _WRAPPERS.append(w)


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every registered wrapper."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
