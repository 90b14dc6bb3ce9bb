"""``CheckpointWriter`` — the write-behind checkpoint thread (the port's
copy of the JAX package's ``resilience/writer.py``).

The train thread calls :meth:`submit` with a host snapshot: flat
{tree-path key: CPU tensor}.  On the card the loop fills pinned host
buffers with ``non_blocking`` copies on the compute stream and passes
the CUDA event recorded after them as ``ready``; the writer thread
waits on that event before it hashes, so the submit never waits for the
steps still in flight.  ``submit`` only places the snapshot into a
single *pending* slot and returns — the stall it adds to the step is
``ckpt_stall_ms``.

The writer thread drains the slot: encodes, hashes and persists the
snapshot through the incremental object store
(:func:`resilience.manifest.persist_snapshot`) and, on the chief,
runs keep-last-K retention. **Latest wins**: if a new snapshot
arrives while the previous one is still being written, the unwritten
pending one is replaced (counted as ``coalesced``) — write-behind
with bounded memory (at most two snapshots alive: pending +
in-write), the behavior a writer slower than ``--ckpt_every`` must
degrade to.

A failed write is remembered and re-raised at the next
:meth:`drain`/:meth:`close` (the ``wait_for_pending_saves``
discipline: a checkpoint that silently failed must not look
durable). :meth:`flush_async` only sets an event — the SIGTERM handler
uses it to make sure the newest captured snapshot reaches disk even if
the main thread never returns to a safe point.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import manifest as manifest_lib


def _clone(a):
    """A private copy of one host tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    return np.array(a, copy=True)


class CheckpointWriter:
    def __init__(self, ckpt_dir: str, process_index: int = 0,
                 process_count: int = 1, keep: int = 0,
                 grace_s: float = 300.0, copy: bool = False,
                 on_written: Optional[Callable[[int, Dict[str, Any]],
                                               None]] = None):
        """``keep``: retention (0 = keep every snapshot). ``copy``:
        defensively copy submitted arrays into the pending slot —
        needed when the caller mutates the submitted tensors in place
        (the loop hands over fresh host copies and leaves it off).
        ``on_written(step, stats)`` fires on the writer thread after
        each snapshot lands (the loop's narration hook).
        """
        self.ckpt_dir = ckpt_dir
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.is_chief = self.process_index == 0
        self.keep = int(keep)
        self.grace_s = float(grace_s)
        self.copy = bool(copy)
        self.on_written = on_written
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._pending: Optional[Dict[str, Any]] = None
        self._stop = False
        self._error: Optional[BaseException] = None
        self._stats = {"submitted": 0, "written": 0, "coalesced": 0,
                       "stall_s_total": 0.0, "write_s_total": 0.0,
                       "objects_written": 0, "objects_reused": 0,
                       "bytes_written": 0, "last_step": None}
        self._pre_persist: Optional[Callable[[], None]] = None  # test hook
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ckpt-writer-{process_index}")
        self._thread.start()

    # -- producer side (train thread) ---------------------------------

    def submit(self, step: int, epoch: int, snapshot: Dict[str, Any],
               extras: Optional[Dict[str, Any]] = None,
               data_state: Optional[Dict[str, Any]] = None,
               leaf_meta: Optional[Dict[str, Dict[str, Any]]] = None,
               ready=None) -> float:
        """Hand one host snapshot to the writer; returns the stall
        seconds this call cost the caller (also accumulated into
        ``stats()['stall_s_total']``).  ``ready``: an event (anything
        with ``synchronize()``) the writer thread waits on before it
        reads the tensors — the non-blocking device-to-host copies'."""
        t0 = time.perf_counter()
        if self.copy:
            # deep copy either shape — sharded list leaves included: a
            # shallow list() would keep the live shards, and the writer
            # thread would hash a torn mid-mutation view
            if ready is not None:
                ready.synchronize()
                ready = None
            snapshot = {
                k: ([(b, _clone(a)) for b, a in v]
                    if isinstance(v, list) else _clone(v))
                for k, v in snapshot.items()}
        item = {"step": int(step), "epoch": int(epoch),
                "snapshot": snapshot, "extras": extras,
                "data_state": data_state, "leaf_meta": leaf_meta,
                "ready": ready}
        with self._lock:
            # error/stop re-checked UNDER the lock: the writer thread
            # dies holding it (error handler), so a snapshot can never
            # land in the slot after the consumer is gone — which
            # would leave _idle cleared and a timeout-less drain (the
            # preemption safe point) blocked forever
            if self._error is not None:
                err = self._error
            elif self._stop:
                raise RuntimeError("CheckpointWriter is closed")
            else:
                err = None
                if self._pending is not None:
                    self._stats["coalesced"] += 1
                self._pending = item
                self._stats["submitted"] += 1
                self._idle.clear()
        if err is not None:
            self._raise_error()
        self._wake.set()
        stall = time.perf_counter() - t0
        with self._lock:
            self._stats["stall_s_total"] += stall
        return stall

    def flush_async(self) -> None:
        """Nudge the writer thread (signal-handler-safe: one event
        set). Pending work is what gets flushed — this never blocks."""
        self._wake.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the pending slot is empty and the in-flight
        write (if any) finished; re-raises a stored writer error.
        Returns False on timeout."""
        ok = self._idle.wait(timeout)
        if self._error is not None:
            self._raise_error()
        return ok

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Flush (unless ``drain=False``) and stop the thread.
        Idempotent; re-raises a stored writer error like drain."""
        if drain and self._thread.is_alive():
            self.drain(timeout)
        with self._lock:
            self._stop = True
            if not drain:
                self._pending = None
                self._idle.set()
        self._wake.set()
        self._thread.join(timeout)
        if self._error is not None:
            self._raise_error()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
        n = max(1, s["submitted"])
        s["ckpt_stall_ms_mean"] = round(s["stall_s_total"] / n * 1e3, 6)
        w = max(1, s["written"])
        s["ckpt_write_ms_mean"] = round(s["write_s_total"] / w * 1e3, 6)
        return s

    # -- consumer side (writer thread) --------------------------------

    def _raise_error(self):
        err, self._error = self._error, None
        raise RuntimeError(
            f"background checkpoint write failed: {err!r}") from err

    def _run(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                item, self._pending = self._pending, None
                if item is None:
                    self._wake.clear()
                    self._idle.set()
                    if self._stop:
                        return
                    continue
            try:
                if self._pre_persist is not None:
                    self._pre_persist()
                t0 = time.perf_counter()
                if item["ready"] is not None:
                    item["ready"].synchronize()
                stats = manifest_lib.persist_snapshot(
                    self.ckpt_dir, item["step"], item["epoch"],
                    item["snapshot"], proc=self.process_index,
                    nprocs=self.process_count, is_chief=self.is_chief,
                    extras=item["extras"],
                    data_state=item["data_state"],
                    leaf_meta=item["leaf_meta"])
                if self.is_chief and self.keep:
                    # retention runs AFTER the root landed, on this
                    # thread — the just-written snapshot counts, and
                    # pruning never races a local in-flight write
                    manifest_lib.prune_snapshots(
                        self.ckpt_dir, self.keep, grace_s=self.grace_s)
                dt = time.perf_counter() - t0
                with self._lock:
                    self._stats["written"] += 1
                    self._stats["write_s_total"] += dt
                    self._stats["objects_written"] += \
                        stats["objects_written"]
                    self._stats["objects_reused"] += \
                        stats["objects_reused"]
                    self._stats["bytes_written"] += \
                        stats["bytes_written"]
                    self._stats["last_step"] = item["step"]
                if self.on_written is not None:
                    try:
                        self.on_written(item["step"], stats)
                    except Exception:
                        pass  # narration must never fail the write
            except BaseException as e:
                with self._lock:
                    self._error = e
                    self._stop = True   # dead consumer: further
                    # submits must raise, never enqueue into a slot
                    # nothing will drain
                    self._pending = None
                    self._idle.set()
                return
