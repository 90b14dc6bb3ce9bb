"""Device synchronization for timing scopes (the JAX package's
``utils/sync.py``).

JAX's ``hard_sync`` fetches a value that depends on every array leaf,
because ``block_until_ready`` could return early on its backend.  On
the card ``torch.cuda.synchronize`` is the barrier: it returns once
every kernel and copy queued on the device has finished.  The trainer
calls ``hard_sync`` on the staged splits so that their one-time upload
stays outside the timed window, as JAX's does.
"""

from __future__ import annotations

from typing import Any

import torch


def _tensor_leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def hard_sync(tree: Any) -> None:
    """Block until every CUDA device that holds a tensor leaf of ``tree``
    has finished its queued work; returns at once for CPU leaves (their
    work is done when the call that made them returns)."""
    devices = {t.device for t in _tensor_leaves(tree)
               if t.device.type == "cuda"}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
