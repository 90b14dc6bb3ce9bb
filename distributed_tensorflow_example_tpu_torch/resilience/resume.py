"""Exact-step auto-resume (``--resume=auto``; the port's copy of the JAX
package's ``resilience/resume.py``).

The snapshot's root manifest carries ``data_state`` — the data
pipeline's exact position at save time: the epoch, the in-epoch batch
skip counter (``batches_done``) and the global step (``steps_done``).
Resume restores the newest valid manifest's tensors, rewinds the
persistent prefetcher to that epoch (the epoch-keyed shuffle replays the
permutation an uninterrupted run used) and drops the first
``batches_done`` batches of that epoch, after which the continuation is
bitwise the run that was never interrupted.  The key-matched rebuild of
the train state stays in ``utils/checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

from . import manifest as manifest_lib


@dataclasses.dataclass(frozen=True)
class ResumePlan:
    """Where to pick the run back up."""

    step: int                 # optimizer steps completed at save time
    epoch: int                # the epoch the save happened inside
    batches_done: int         # batches of that epoch already consumed
    extras: Dict[str, Any]    # driver-side scalar counters
    root_path: str            # the manifest this plan came from


def plan_from_manifest(manifest: Dict[str, Any],
                       root_path: str) -> ResumePlan:
    ds = manifest.get("data_state") or {}
    return ResumePlan(
        step=int(manifest["step"]),
        epoch=int(ds.get("epoch", manifest.get("epoch", 0))),
        batches_done=int(ds.get("batches_done", 0)),
        extras=dict(manifest.get("extras") or {}),
        root_path=root_path,
    )


def auto_resume(ckpt_dir: str) -> Optional[Tuple[ResumePlan, Dict[str, Any]]]:
    """(plan, flat {tree-path key: CPU tensor}) from the newest
    RESTORABLE snapshot under ``ckpt_dir``, or None when there is
    nothing to resume from (a fresh run). Walks back past torn
    snapshots: manifest validity covers file EXISTENCE, but a power
    loss can leave a visible object whose payload never hit the
    platters — so a restore failure (unreadable/truncated object,
    coverage gap) also falls back to the previous snapshot instead of
    killing the relaunch at startup."""
    import os

    for _step, name in reversed(manifest_lib.list_snapshots(ckpt_dir)):
        root_path = os.path.join(ckpt_dir, name)
        try:
            manifest = manifest_lib.load_manifest(root_path)
            if not manifest_lib.snapshot_valid(ckpt_dir, manifest):
                continue
            data, _s, _e = manifest_lib.restore_arrays(ckpt_dir,
                                                       manifest)
        except Exception as e:  # torn payload: fall back, loudly
            print(f"NOTE: snapshot {name} unrestorable ({e!r}); "
                  f"falling back to the previous one")
            continue
        return plan_from_manifest(manifest, root_path), data
    return None


def skip_batches(batches: Iterable, n: int) -> Iterator:
    """Drop the first ``n`` items — the in-epoch replay skip. The
    producer still generates them (the epoch's deterministic order is
    exactly what makes the skip land on the right batch); raises if
    the epoch ends early, because a short epoch means the saved
    position is from a DIFFERENT data configuration and silently
    resuming would train on the wrong batches."""
    it = iter(batches)
    for i in range(n):
        try:
            next(it)
        except StopIteration:
            raise RuntimeError(
                f"resume skip: epoch ended after {i} batches but the "
                f"snapshot recorded {n} consumed — the data pipeline "
                f"(batch size / dataset) changed since the save")
    return it
