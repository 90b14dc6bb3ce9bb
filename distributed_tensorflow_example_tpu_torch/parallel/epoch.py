"""The device-resident epoch: the trainer's default fast path (the JAX
package's ``parallel/epoch.py``, for one process).

- The whole training split is uploaded once (``shard_dataset``): trimmed
  to ``n_keep``, a whole number of batches, and stored as uint8 where
  the pixels are exactly k/255 (``pack_images``; real MNIST and the
  synthetic set always are), normalized to f32 inside the step by a
  division by ``float32(255)`` (``normalize``), so the fast path trains
  on the same bits as the host path.
- Each epoch draws its permutation on the device, ``jax.random.
  permutation(fold_in(fold_in(PRNGKey(seed + 0x5EED), shard), epoch),
  n_keep)`` bit for bit (``utils/prng.py``), gathers the split once
  into a preallocated shuffled copy (one ``index_select``), then runs
  ``steps_per_epoch`` steps over its contiguous slices.
- Per-step cost and accuracy are written into device arrays that the
  caller fetches once per epoch or once per run
  (``build_run_to_completion``, ``build_epoch_runner``).
- ``build_fast_eval`` stages the test split once, in chunks of
  ``min(eval_chunk_cap(spec, n), n)`` examples, and counts the correct
  predictions with one fetch.

**Which families capture.**  The MLP family's step runs as a CUDA graph
on the card (``CAPTURED_FAMILIES``): one step is captured after a
warm-up on a side stream, with its params, optimizer slots and step
counter in static buffers that the captured step updates in place; its
batch is read through a device step counter (an ``index_select`` on
``arange(b) + i * b`` computed in the graph, the counterpart of JAX's
``dynamic_slice``) and its cost and accuracy are written with
``index_copy_``.  An epoch is then ``steps_per_epoch`` replays and no
host sync.  The transformer family (MoE included) runs the same
device-resident epoch eagerly: no per-step host copy or read, the
dropout seed from the host's step index.  On the CPU every family runs
eagerly (there is no graph to capture).  The choice is static; a capture
that fails raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..models import transformer as tfm
from ..ops import _counts
from ..train.optim import tree_leaves, tree_map
from ..train.state import TrainState
from ..utils import prng
from . import step as step_lib

# the model families whose step is captured in a CUDA graph on the card
CAPTURED_FAMILIES = ("mlp",)
# eager steps run on a side stream before the capture (cuBLAS handles,
# autograd's and the allocator's first-use work); the state is restored
# after them, so they change nothing the run computes
WARMUP_STEPS = 2
# the key the per-epoch permutations fold from: PRNGKey(seed + SHUFFLE_SALT)
SHUFFLE_SALT = 0x5EED


def pack_images(images: np.ndarray) -> np.ndarray:
    """uint8 when every pixel is exactly k/255 (then ``normalize``
    gives back the same f32 bits), else the f32 images unchanged."""
    q = np.round(np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)
    # division, not reciprocal-multiply: matches the IDX loader's `/ 255.0`
    # bit-for-bit (they differ in the last ulp for some pixel values)
    if np.array_equal(q.astype(np.float32) / np.float32(255.0), images):
        return q
    return images.astype(np.float32)


def _divisor(device) -> torch.Tensor:
    """255 as an f32 tensor on ``device``: dividing by a tensor on the
    card runs a true division, where a Python scalar divisor would be
    turned into a multiply by its reciprocal (one ulp off for some
    pixels)."""
    return torch.full((), 255.0, dtype=torch.float32, device=device)


def normalize(img: torch.Tensor, divisor: torch.Tensor = None
              ) -> torch.Tensor:
    """The inverse of ``pack_images`` on the device: uint8 -> f32 / 255
    (``divisor``: ``_divisor(img.device)``, prebuilt where the call is
    captured); f32 passes through."""
    if img.dtype != torch.uint8:
        return img
    if divisor is None:
        divisor = _divisor(img.device)
    return img.to(torch.float32) / divisor


def shard_dataset(images: np.ndarray, labels: np.ndarray, batch: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(images, labels, steps_per_epoch)`` of the split on ``device``
    for one process: trimmed to ``n_keep = (n // batch) * batch``, the
    images packed (``pack_images``), uploaded once."""
    n_keep = (images.shape[0] // batch) * batch
    img = np.ascontiguousarray(pack_images(images[:n_keep]))
    lbl = np.ascontiguousarray(labels[:n_keep], dtype=np.float32)
    return (torch.from_numpy(img).to(device),
            torch.from_numpy(lbl).to(device), n_keep // batch)


def captures(spec, device) -> bool:
    """Whether the step of ``spec`` runs as a CUDA graph on ``device``."""
    family = ("transformer" if isinstance(spec, tfm.TransformerSpec)
              else "mlp")
    return (torch.device(device).type == "cuda"
            and family in CAPTURED_FAMILIES)


def _copy_state(dst: TrainState, src: TrainState) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


def _leaves(state: TrainState) -> list:
    return ([state.step] + tree_leaves(state.params)
            + tree_leaves(state.opt_state))


def _clone_state(state: TrainState) -> TrainState:
    def clone(t):
        return t.clone() if isinstance(t, torch.Tensor) else t

    return TrainState(state.step.clone(), tree_map(clone, state.params),
                      tree_map(clone, state.opt_state))


class _Runner:
    """``(state, images, labels, key, epoch_offset=0) -> (state,
    costs [E, spe], accs [E, spe])`` on the device: ``num_epochs``
    epochs of ``steps_per_epoch`` steps, from epoch ``epoch_offset``.
    The returned arrays are device tensors the caller fetches.  The
    state passed in is consumed, as JAX donates it (``donate_argnums``):
    the run updates that ``TrainState`` and returns it, so no second
    copy of the params and slots outlives the first step."""

    def __init__(self, cfg, spec, optimizer, steps_per_epoch: int,
                 num_epochs: int):
        self.cfg, self.spec = cfg, spec
        self.spe, self.num_epochs = steps_per_epoch, num_epochs
        self.body = step_lib.make_sync_step_body(cfg, spec, optimizer)
        self._shuf = None           # (images, labels), allocated once

    def _shuffle(self, img, lbl, key, epoch: int) -> None:
        """Epoch ``epoch``'s permutation on the device, and the split
        gathered through it into the preallocated shuffled copy."""
        if self._shuf is None:
            self._shuf = (torch.empty_like(img), torch.empty_like(lbl))
        perm = prng.permutation(
            prng.fold_in(prng.fold_in(key, 0), epoch), img.shape[0],
            img.device)
        torch.index_select(img, 0, perm, out=self._shuf[0])
        torch.index_select(lbl, 0, perm, out=self._shuf[1])

    def _check(self, img) -> int:
        n = img.shape[0]
        if n % self.spe:
            raise ValueError(f"{n} examples do not split into "
                             f"{self.spe} steps")
        return n // self.spe


class _EagerRunner(_Runner):
    """Each step called from Python over a contiguous slice of the
    shuffled copy; nothing is read back from the device."""

    def __call__(self, state, img, lbl, key, epoch_offset: int = 0):
        b = self._check(img)
        dev = img.device
        divisor = _divisor(dev)
        costs = torch.empty((self.num_epochs, self.spe), dtype=torch.float32,
                            device=dev)
        accs = torch.empty_like(costs)
        for e in range(self.num_epochs):
            epoch = epoch_offset + e
            self._shuffle(img, lbl, key, epoch)
            shuf_img, shuf_lbl = self._shuf
            for i in range(self.spe):
                x = normalize(shuf_img[i * b:(i + 1) * b], divisor)
                y = shuf_lbl[i * b:(i + 1) * b]
                new, cost, acc = self.body(state, x, y,
                                           step_index=epoch * self.spe + i)
                state.step, state.params, state.opt_state = (
                    new.step, new.params, new.opt_state)
                costs[e, i] = cost
                accs[e, i] = acc
        return state, costs, accs


class _GraphRunner(_Runner):
    """One step captured in a CUDA graph and replayed ``steps_per_epoch``
    times an epoch.  The state lives in static buffers: the first call
    takes the given state's tensors as them, and every call returns
    them as its state (a call given another state copies it in).  The step counter
    ``_i`` (a device int64) picks the batch, and the slot of the cost
    and accuracy arrays, inside the graph and advances there."""

    def __init__(self, *args):
        super().__init__(*args)
        self.graph = None
        self.static = None
        self.delta = {}             # wrapper launches of one captured step

    def _step(self, x_all, y_all, b: int) -> None:
        """One step on the static buffers: the body, its results copied
        into the state, cost and accuracy into their slots."""
        i = torch.remainder(self._i, self.spe)
        idx = self._arange + i * b
        x = normalize(x_all.index_select(0, idx), self._divisor)
        y = y_all.index_select(0, idx)
        new, cost, acc = self.body(self.static, x, y)
        _copy_state(self.static, new)
        slot = self._i.view(1)
        self._costs.index_copy_(0, slot, cost.to(torch.float32).view(1))
        self._accs.index_copy_(0, slot, acc.to(torch.float32).view(1))
        self._i.add_(1)

    def _capture(self, img, lbl, b: int) -> None:
        dev = img.device
        self._divisor = _divisor(dev)
        self._arange = torch.arange(b, dtype=torch.int64, device=dev)
        self._i = torch.zeros((), dtype=torch.int64, device=dev)
        n_out = self.num_epochs * self.spe
        self._costs = torch.zeros(n_out, dtype=torch.float32, device=dev)
        self._accs = torch.zeros_like(self._costs)
        x_all, y_all = self._shuf
        saved = _clone_state(self.static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(x_all, y_all, b)
        torch.cuda.current_stream(dev).wait_stream(side)
        _copy_state(self.static, saved)
        del saved
        before = _counts.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end on the side stream, not ``torch.cuda.graph``,
        # whose entry synchronizes and empties the allocator's cache (and
        # may run a full garbage collection): host time that grows with
        # what the process holds, and lands in the run's timed window
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin()
            self._step(x_all, y_all, b)
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        after = _counts.launch_counts()
        # the capture recorded launches without running them
        self.delta = {k: n - before[k] for k, n in after.items()
                      if n != before[k]}
        _counts.add_launches({k: -n for k, n in self.delta.items()})
        self.graph = graph

    def __call__(self, state, img, lbl, key, epoch_offset: int = 0):
        b = self._check(img)
        if self.static is None:
            self.static = state
        elif state is not self.static:
            _copy_state(self.static, state)
        for e in range(self.num_epochs):
            self._shuffle(img, lbl, key, epoch_offset + e)
            if self.graph is None:
                self._capture(img, lbl, b)
            if e == 0:
                self._i.zero_()
            for _ in range(self.spe):
                self.graph.replay()
                _counts.add_launches(self.delta)
        shape = (self.num_epochs, self.spe)
        return (self.static, self._costs.view(shape).clone(),
                self._accs.view(shape).clone())


def build_run_to_completion(cfg, spec, optimizer, steps_per_epoch: int,
                            num_epochs: int, device) -> Callable:
    """The whole run on the device: ``(state, images, labels, key,
    epoch_offset=0) -> (state, costs [E, spe], accs [E, spe])``, the
    step captured in a CUDA graph where ``captures(spec, device)``."""
    cls = _GraphRunner if captures(spec, device) else _EagerRunner
    return cls(cfg, spec, optimizer, steps_per_epoch, num_epochs)


def build_epoch_runner(cfg, spec, optimizer, steps_per_epoch: int,
                       device) -> Callable:
    """One epoch a call, for host control between epochs (periodic
    checkpoints): ``(state, images, labels, key, epoch) -> (state,
    costs [spe], accs [spe])``."""
    run1 = build_run_to_completion(cfg, spec, optimizer, steps_per_epoch,
                                   1, device)

    def runner(state, img, lbl, key, epoch: int):
        state, costs, accs = run1(state, img, lbl, key, epoch)
        return state, costs[0], accs[0]

    runner.run1 = run1
    return runner


def build_fast_eval(cfg, spec, images: np.ndarray, labels: np.ndarray,
                    device) -> Callable:
    """The test split staged on ``device`` once — packed, zero-padded to
    whole chunks of ``min(eval_chunk_cap(spec, n), n)`` examples, the
    padding masked — and ``params -> accuracy`` over it, with one fetch.
    ``.dispatch(params)`` returns the correct count as a device scalar
    without fetching it; ``.n`` is the example count."""
    n = images.shape[0]
    chunk = max(1, min(step_lib.eval_chunk_cap(spec, n), n))
    n_pad = -(-n // chunk) * chunk
    packed = pack_images(images)
    img = np.zeros((n_pad, images.shape[1]), packed.dtype)
    img[:n] = packed
    lbl = np.zeros((n_pad, labels.shape[1]), np.float32)
    lbl[:n] = labels
    mask = (np.arange(n_pad) < n).astype(np.float32)
    img_d = torch.from_numpy(img).to(device)
    lbl_d = torch.from_numpy(lbl).to(device)
    mask_d = torch.from_numpy(mask).to(device)
    divisor = _divisor(img_d.device)
    eval_step = step_lib.build_eval_step(cfg, spec)

    def dispatch(params) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=img_d.device)
        for off in range(0, n_pad, chunk):
            sl = slice(off, off + chunk)
            total += eval_step(params, normalize(img_d[sl], divisor),
                               lbl_d[sl], mask_d[sl])
        return total

    def evaluate(params) -> float:
        return float(dispatch(params)) / n

    evaluate.dispatch = dispatch
    evaluate.n = n
    evaluate.staged = (img_d, lbl_d, mask_d)
    return evaluate


__all__ = ["CAPTURED_FAMILIES", "SHUFFLE_SALT", "pack_images", "normalize",
           "shard_dataset", "captures", "build_run_to_completion",
           "build_epoch_runner", "build_fast_eval"]
