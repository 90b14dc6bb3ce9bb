"""Background batch prefetchers for the host-fed loop (the JAX
package's ``data/prefetch.py``).

Three stages, composable (the host path, ``--no_fast_loop``, uses all
three; the default fast path keeps the whole split on the card and
needs no host feeding):

- ``Prefetcher``: a daemon thread runs ahead of the consumer through a
  small bounded queue.  The gather is numpy fancy indexing (in
  ``EpochIterator``), where the JAX package calls its native C++
  ``gather_batch``.
- ``EpochPrefetcher``: the persistent epoch-aware variant — ONE
  producer thread spans every epoch of the run (epoch-keyed rewind via
  :meth:`EpochPrefetcher.epoch`), so epoch boundaries pay no cold
  thread/queue spin-up and the next epoch's gather overlaps the
  between-epoch host work (eval, checkpoints).
- ``DevicePrefetcher``: the device-side stage (``--device_prefetch``)
  — commits upcoming host batches to the device up to ``depth``
  batches ahead of consumption.  On the card the producer thread
  gathers each batch straight into pinned host memory
  (``pinned_batches``), and the commit (``CopyStreamCommit``) copies it
  with ``non_blocking`` copies on a copy stream and records an event;
  the consumer's stream waits on that event before the step (``take``),
  and ``record_stream`` tells the allocator the batch is used there.
  So the copy of batch N+k overlaps the step of batch N.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

_END = object()


class _EpochEnd:
    """Queue marker: the producer finished epoch ``epoch``."""

    __slots__ = ("epoch",)

    def __init__(self, epoch: int):
        self.epoch = epoch


class Prefetcher:
    """Wraps an iterable of batches; yields the same batches, produced
    by a background thread with ``depth`` batches of lookahead."""

    def __init__(self, iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iterable,), daemon=True
        )
        self._thread.start()

    def _produce(self, iterable) -> None:
        try:
            for item in iterable:
                # bounded put that notices close(): never blocks forever
                # holding the iterator's buffers if the consumer bails out
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surface producer errors to the consumer
            self._err.append(e)
        finally:
            # deliver the sentinel unless closed (a Full queue must not
            # lose it, or the consumer would block forever)
            while not self._stop.is_set():
                try:
                    self._q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the producer and release its buffers (safe to call
        multiple times; called by consumers on early exit)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def _check_open(self) -> None:
        """A closed prefetcher has no producer and a drained queue (no
        sentinel left): iterating it would block forever on a ``get``
        that can never complete — fail fast instead."""
        if self._stop.is_set():
            raise RuntimeError(
                f"{type(self).__name__} is closed; create a new one "
                f"instead of iterating a closed prefetcher")

    def _get(self):
        """Blocking queue read that keeps noticing ``close()``: the
        sentinel may already be gone by the time the consumer blocks."""
        while True:
            self._check_open()
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                continue

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        # eager check: iter() on a closed prefetcher raises at the
        # call, not at the first next() (generators run lazily)
        self._check_open()
        return self._iter()

    def _iter(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        try:
            while True:
                item = self._get()
                if item is _END:
                    if self._err:
                        raise self._err[0]
                    return
                yield item
        finally:
            self.close()


class EpochPrefetcher(Prefetcher):
    """One persistent producer across every epoch of a run.

    ``epoch_fn(e)`` must return epoch ``e``'s batch iterator (e.g.
    ``EpochIterator.epoch``). The single producer thread runs the
    epochs of ``epoch_indices`` back to back, separated by epoch-end
    markers — while the consumer evaluates/checkpoints between epochs
    the producer is already gathering the next epoch's batches, and no
    epoch pays a cold thread/queue spin-up.

    :meth:`epoch` is the epoch-keyed rewind: it yields exactly epoch
    ``e``'s batches, first dropping whatever the consumer left behind
    of earlier epochs. The stream is forward-only — epochs can only be
    consumed in the order produced (re-requesting a finished epoch
    raises), which is all the train loop needs and what keeps this one
    bounded queue instead of a cache.
    """

    def __init__(self, epoch_fn: Callable[[int], Iterator],
                 epoch_indices, depth: int = 2):
        self._indices = list(epoch_indices)
        self._pos = 0   # consumer cursor into _indices (the epoch at
                        # the queue head, barring in-flight markers)
        self._next_allowed = 0  # hand-out cursor: epochs at earlier
                                # indices were already handed to a
                                # consumer (possibly partially drained)
        super().__init__(self._chain(epoch_fn, self._indices), depth)

    def __iter__(self):
        raise TypeError(
            "EpochPrefetcher is consumed per epoch — use .epoch(e); "
            "direct iteration would interleave internal epoch markers "
            "with batches")

    @staticmethod
    def _chain(epoch_fn, indices):
        for e in indices:
            yield from epoch_fn(e)
            yield _EpochEnd(e)

    def _advance(self, finished_epoch: int) -> None:
        self._pos = self._indices.index(finished_epoch) + 1

    def epoch(self, e: int) -> Iterator:
        """Yield epoch ``e``'s batches (epoch-keyed rewind)."""
        if e not in self._indices:
            raise RuntimeError(
                f"epoch {e} is not in this prefetcher's sequence "
                f"{self._indices!r}")
        # forward-only against the HAND-OUT cursor, not just the queue
        # position: re-requesting an epoch that was already handed out
        # (even if only partially drained) would silently yield a
        # truncated epoch, never 'exactly epoch e's batches'
        if self._indices.index(e) < self._next_allowed:
            raise RuntimeError(
                f"epoch {e} was already consumed (or started) — the "
                f"prefetch stream is forward-only")
        self._next_allowed = self._indices.index(e) + 1
        return self._epoch_iter(e)

    def _epoch_iter(self, e: int) -> Iterator:
        # fast-forward: drop earlier epochs' leftovers (a consumer that
        # abandoned an epoch mid-way rewinds to the next epoch's start)
        while self._pos < len(self._indices) and self._indices[self._pos] != e:
            item = self._get()
            if item is _END:
                if self._err:
                    raise self._err[0]
                raise RuntimeError(f"stream ended before epoch {e}")
            if isinstance(item, _EpochEnd):
                self._advance(item.epoch)
        while True:
            item = self._get()
            if item is _END:
                if self._err:
                    raise self._err[0]
                raise RuntimeError(f"stream ended inside epoch {e}")
            if isinstance(item, _EpochEnd):
                self._advance(item.epoch)
                return
            yield item


class DevicePrefetcher:
    """Bounded depth-K device-commit pipeline — the H2D overlap stage.

    Pulls host batches from a source iterator and immediately commits
    each via ``commit(x, y)`` (``CopyStreamCommit`` on the card),
    keeping up to ``depth`` committed batches buffered ahead of the
    consumer.  The copies are asynchronous — ``commit`` returns as soon
    as they are enqueued — so the transfer of batch N+k proceeds while
    the device executes batch N, and the train loop steps on tensors
    that are already (becoming) device-resident instead of paying the
    copy on the critical path.

    Pure python, no thread of its own: the commit call is cheap host
    work (the transfer engine does the copying), and running it inline
    on the consumer thread commits batches in exactly the order the
    source yields them — which is what keeps the device-prefetched
    path bit-exact with the synchronous-commit path.

    One instance persists across epochs: :meth:`rewind` re-arms the
    same object on the next epoch's source, dropping any buffered
    batches from the old source (the arrays just release) and clearing
    a pending source error. :meth:`close` releases the buffer and
    makes further iteration raise — early-exit safe. A source error
    surfaces after the already-committed batches, mirroring
    ``Prefetcher``'s ordering.
    """

    def __init__(self, commit: Callable, depth: int = 2, source=None):
        if depth < 1:
            raise ValueError(f"depth={depth} must be >= 1")
        self._commit = commit
        self._depth = depth
        self._buf: collections.deque = collections.deque()
        self._it = iter(source) if source is not None else None
        self._err: Optional[BaseException] = None
        self._done = source is None
        self._closed = False

    @property
    def depth(self) -> int:
        return self._depth

    def rewind(self, source) -> "DevicePrefetcher":
        """Re-arm on a new source (the next epoch); returns self."""
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        self._buf.clear()
        self._it = iter(source)
        self._err = None
        self._done = False
        return self

    def close(self) -> None:
        """Drop buffered device batches and refuse further iteration
        (idempotent; called by consumers on early exit)."""
        self._closed = True
        self._buf.clear()
        self._it = None
        self._done = True

    @property
    def closed(self) -> bool:
        return self._closed

    def _fill(self) -> None:
        while not self._done and len(self._buf) < self._depth:
            try:
                item = next(self._it)
            except StopIteration:
                self._done = True
                return
            except Exception as e:  # surfaced after buffered items.
                # NOT BaseException: _fill runs on the consumer thread
                # (unlike Prefetcher._produce), so a KeyboardInterrupt
                # must stop the run now, not resurface `depth` steps
                # later disguised as a data-pipeline failure
                self._err = e
                self._done = True
                return
            self._buf.append(self._commit(*item))

    def __iter__(self) -> Iterator:
        # eager check, like Prefetcher: iter() on a closed instance
        # raises at the call, not at the first next()
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        return self._iter()

    def _iter(self) -> Iterator:
        self._fill()
        while True:
            if self._closed:
                raise RuntimeError("DevicePrefetcher is closed")
            if not self._buf:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                return
            item = self._buf.popleft()
            yield item
            self._fill()


def pinned_batches(split, index_batches) -> Iterator[Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """The batches of ``index_batches`` (``EpochIterator.batch_indices``)
    gathered straight into pinned host memory: one copy a batch, by
    ``torch.index_select``, which leaves the interpreter lock free for
    the consumer while a producer thread runs it.  The same values as
    ``EpochIterator.epoch``'s numpy batches."""
    images = torch.from_numpy(split.images)
    labels = torch.from_numpy(split.labels)
    for idx in index_batches:
        i = torch.from_numpy(idx)
        x = torch.empty((len(idx),) + tuple(images.shape[1:]),
                        dtype=images.dtype, pin_memory=True)
        y = torch.empty((len(idx),) + tuple(labels.shape[1:]),
                        dtype=labels.dtype, pin_memory=True)
        torch.index_select(images, 0, i, out=x)
        torch.index_select(labels, 0, i, out=y)
        yield x, y


class CopyStreamCommit:
    """``(x, y) -> (x, y, ready)`` on ``device``, from numpy arrays or
    CPU tensors.  On the card the batch is copied to the card from
    pinned host memory (``pinned_batches``'s, or a pinned copy made
    here) with ``non_blocking`` copies on a copy stream of its own;
    ``ready`` is a CUDA event recorded after the copies (``take`` makes
    the consuming stream wait on it).  On the CPU the batch is wrapped
    as it is and ``ready`` is None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, x, y):
        hx, hy = torch.as_tensor(x), torch.as_tensor(y)
        if self.stream is None:
            return hx, hy, None
        if not hx.is_pinned():
            hx = hx.pin_memory()
        if not hy.is_pinned():
            hy = hy.pin_memory()
        with torch.cuda.stream(self.stream):
            dx = hx.to(self.device, non_blocking=True)
            dy = hy.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return dx, dy, ready


def take(x: torch.Tensor, y: torch.Tensor, ready) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """A committed batch, made safe to use on the current stream: the
    stream waits on the copy's event, and the allocator learns that the
    tensors (allocated on the copy stream) are used on this one."""
    if ready is not None:
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(ready)
        x.record_stream(stream)
        y.record_stream(stream)
    return x, y
