"""The device-resident epoch: the trainer's default fast path (the JAX
package's ``parallel/epoch.py``), at any world size: rank r plays
device r of JAX's one-process ``('data', 'model')`` mesh, so its shard
of the split and its permutation are those of its data index (the model
ranks of one data index share them).

- Each rank uploads its shard of the training split once
  (``shard_dataset``): the split trimmed so every rank holds a whole
  number of its ``batch / dp`` rows a step, and rank r the contiguous
  shard r, stored as uint8 where the pixels are exactly k/255
  (``pack_images``; real MNIST and the synthetic set always are),
  normalized to f32 inside the step by a division by ``float32(255)``
  (``normalize``), so the fast path trains on the same bits as the host
  path.
- Each epoch, the rank at data index d draws its permutation on the
  device, ``jax.random.permutation(fold_in(fold_in(PRNGKey(seed +
  0x5EED), d), epoch), n_local)`` bit for bit (``utils/prng.py``),
  gathers its shard once into a preallocated shuffled copy (one
  ``index_select``), then runs ``steps_per_epoch`` steps over its
  contiguous slices.
- The step is the synchronous one (its all-reduce inside the step,
  captured in the CUDA graph on the card), FSDP's
  (``parallel/fsdp.py``), or local SGD's: K local steps, then the
  replicas' average (``step.param_sync``).  The host knows the step
  index, so only every K-th step averages (JAX decides with
  ``lax.cond`` on the device): on the card two graphs are captured over
  the same buffers, the local step and the local step followed by the
  average, and each step replays the one it needs.  Two graphs rather
  than K steps in one: any K and any epoch length, and no step is
  captured twice.
- Per-step cost and accuracy are written into device arrays that the
  caller fetches once per epoch or once per run
  (``build_run_to_completion``, ``build_epoch_runner``).
- ``build_fast_eval`` stages the test split once, in chunks of
  ``min(eval_chunk_cap(spec, n), n)`` examples rounded up to a multiple
  of ``dp`` (rank r its rows of each chunk), and counts the correct
  predictions, summed over the ranks, with one fetch.

**Which families capture.**  The MLP family's step runs as a CUDA graph
on the card (``CAPTURED_FAMILIES``): one step is captured after a
warm-up on a side stream, with its params, optimizer slots and step
counter in static buffers that the captured step updates in place; its
batch is read through a device step counter (an ``index_select`` on
``arange(b) + i * b`` computed in the graph, the counterpart of JAX's
``dynamic_slice``) and its cost and accuracy are written with
``index_copy_``.  An epoch is then ``steps_per_epoch`` replays and no
host sync.  The collectives need groups that have already run one
collective before the capture: one all-reduce on each of the mesh's
groups, and the eager warm-up steps, run them.  A CUDA graph cannot
capture a gloo collective: under a gloo group on the card the captured
epoch raises, naming ``--no_fast_loop``, and never falls back.
The transformer family (MoE included) runs the same device-resident
epoch eagerly: no per-step host copy or read, the dropout seed from the
host's step index.  On the CPU every family runs eagerly (there is no
graph to capture).  The choice is static; a capture that fails raises.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Unported
from ..models import transformer as tfm
from ..ops import _counts
from ..train.optim import tree_leaves, tree_map
from ..train.state import TrainState
from ..utils import prng
from . import mesh as mesh_lib
from . import step as step_lib

# the model families whose step is captured in a CUDA graph on the card
CAPTURED_FAMILIES = ("mlp",)
# eager steps run on a side stream before the capture (cuBLAS handles,
# autograd's and the allocator's first-use work); the state is restored
# after them, so they change nothing the run computes
WARMUP_STEPS = 2
# the key the per-epoch permutations fold from: PRNGKey(seed + SHUFFLE_SALT)
SHUFFLE_SALT = 0x5EED
# JAX's gate sends sequence parallelism to the host path: the epoch's
# device-resident shard holds whole rows of the data index, not the seq
# index's token columns
SEQ_EPOCH_REFUSED = (
    "the device-resident epoch takes no seq axis (--sequence_parallel "
    "runs on the host path, as JAX's gate sends it; see ROADMAP.md)")
# and expert parallelism too: the epoch's state is replicated whole
EXPERT_EPOCH_REFUSED = (
    "the device-resident epoch takes no expert axis (--expert_parallel "
    "runs on the host path, as JAX's gate sends it; see ROADMAP.md)")
# and pipeline parallelism: the epoch's state is not the stacked layout
STAGE_EPOCH_REFUSED = (
    "the device-resident epoch takes no stage axis (--pipeline_parallel "
    "runs on the host path, as JAX's gate sends it; see ROADMAP.md)")


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
                  device, dp: int = 1, rank: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(images, labels, steps_per_epoch)`` of rank ``rank``'s shard on
    ``device``, as JAX places device ``rank``'s: every rank holds
    ``per_shard = (n // dp // local) * local`` rows (``local = batch //
    dp``), rank r rows ``[r * per_shard, (r+1) * per_shard)``, the
    images packed (``pack_images``), uploaded once."""
    local = batch // dp
    per_shard = (images.shape[0] // dp // local) * local
    rows = slice(rank * per_shard, (rank + 1) * per_shard)
    img = np.ascontiguousarray(pack_images(images[rows]))
    lbl = np.ascontiguousarray(labels[rows], dtype=np.float32)
    return (torch.from_numpy(img).to(device),
            torch.from_numpy(lbl).to(device), per_shard // local)


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
    copy of the params and slots outlives the first step.
    ``compile_s`` is the host wall of the CUDA graph's warm-up and
    capture (0 for an eager runner): the trainer logs it as the
    ``compile`` event and keeps it out of its metrics rows' step time,
    as JAX keeps its compile out.

    ``body`` is the step (default: the synchronous one, which masks a
    flagged update under ``--on_anomaly=skip``); ``sync_period`` K > 0
    runs ``step.param_sync`` after every step whose 1-based global
    index is a multiple of K (local SGD)."""

    def __init__(self, cfg, spec, optimizer, steps_per_epoch: int,
                 num_epochs: int, body: Optional[Callable] = None,
                 sync_period: int = 0, mesh=None):
        self.cfg, self.spec = cfg, spec
        self.spe, self.num_epochs = steps_per_epoch, num_epochs
        self.mesh = mesh if mesh is not None else mesh_lib.build_mesh(-1)
        if self.mesh.sp > 1:
            raise Unported(SEQ_EPOCH_REFUSED)
        if self.mesh.ep > 1:
            raise Unported(EXPERT_EPOCH_REFUSED)
        if self.mesh.pp > 1:
            raise Unported(STAGE_EPOCH_REFUSED)
        self.body = body or step_lib.make_sync_step_body(cfg, spec,
                                                         optimizer,
                                                         mesh=self.mesh)
        self.sync_period = sync_period
        self.rank = self.mesh.data_index
        self._shuf = None           # (images, labels), allocated once
        self.compile_s = 0.0

    def _syncs(self, global_step: int) -> bool:
        """Whether the step at 0-based ``global_step`` ends with the
        replicas' average."""
        k = self.sync_period
        return bool(k) and (global_step + 1) % k == 0

    def _shuffle(self, img, lbl, key, epoch: int) -> None:
        """Epoch ``epoch``'s permutation of this rank's shard on the
        device, and the shard gathered through it into the preallocated
        shuffled copy."""
        if self._shuf is None:
            self._shuf = (torch.empty_like(img), torch.empty_like(lbl))
        perm = prng.permutation(
            prng.fold_in(prng.fold_in(key, self.rank), epoch), img.shape[0],
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
                g = epoch * self.spe + i
                new, cost, acc = self.body(state, x, y, step_index=g)
                if self._syncs(g):
                    new = step_lib.param_sync(new)
                state.step, state.params, state.opt_state = (
                    new.step, new.params, new.opt_state)
                costs[e, i] = cost
                accs[e, i] = acc
        return state, costs, accs


class _GraphRunner(_Runner):
    """One step captured in a CUDA graph and replayed ``steps_per_epoch``
    times an epoch (under local SGD two graphs over the same buffers:
    the local step, and the local step followed by the average).  The
    state lives in static buffers: the first call takes the given
    state's tensors as them, and every call returns them as its state (a
    call given another state copies it in).  The step counter ``_i`` (a
    device int64) picks the batch, and the slot of the cost and accuracy
    arrays, inside the graph and advances there."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.graphs = None          # {averages: CUDAGraph}
        self.static = None
        self.delta = {}             # {averages: wrapper launches of one
                                    # captured step}

    def _step(self, x_all, y_all, b: int, average: bool) -> None:
        """One step on the static buffers: the body (and the average),
        its results copied into the state, cost and accuracy into their
        slots."""
        i = torch.remainder(self._i, self.spe)
        idx = self._arange + i * b
        x = normalize(x_all.index_select(0, idx), self._divisor)
        y = y_all.index_select(0, idx)
        new, cost, acc = self.body(self.static, x, y)
        if average:
            new = step_lib.param_sync(new)
        _copy_state(self.static, new)
        slot = self._i.view(1)
        self._costs.index_copy_(0, slot, cost.to(torch.float32).view(1))
        self._accs.index_copy_(0, slot, acc.to(torch.float32).view(1))
        self._i.add_(1)

    def _variants(self) -> tuple:
        """The step forms the run replays: the plain step, the step
        with the average (local SGD), or both."""
        if self.sync_period == 1:
            return (True,)
        return (False, True) if self.sync_period else (False,)

    def _capture(self, img, lbl, b: int) -> None:
        dev = img.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        self._divisor = _divisor(dev)
        self._arange = torch.arange(b, dtype=torch.int64, device=dev)
        self._i = torch.zeros((), dtype=torch.int64, device=dev)
        n_out = self.num_epochs * self.spe
        self._costs = torch.zeros(n_out, dtype=torch.float32, device=dev)
        self._accs = torch.zeros_like(self._costs)
        x_all, y_all = self._shuf
        variants = self._variants()
        saved = _clone_state(self.static)
        # every group of the mesh runs one collective before the capture
        for group in mesh_lib.groups(self.mesh):
            dist.all_reduce(torch.zeros(1, device=dev), group=group)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # the eager warm-up also runs the collectives once: a group
        # must have run one before a capture records its kernels
        with torch.cuda.stream(side):
            for w in range(WARMUP_STEPS):
                self._step(x_all, y_all, b, variants[w % len(variants)])
        torch.cuda.current_stream(dev).wait_stream(side)
        _copy_state(self.static, saved)
        del saved
        self.graphs, pool = {}, None
        for average in variants:
            before = _counts.launch_counts()
            graph = torch.cuda.CUDAGraph()
            # capture_begin/end on the side stream, not ``torch.cuda.
            # graph``, whose entry synchronizes and empties the
            # allocator's cache (and may run a full garbage collection):
            # host time that grows with what the process holds, and
            # lands in the run's timed window.  The graphs share one
            # memory pool: they never run at once
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                self._step(x_all, y_all, b, average)
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            pool = graph.pool()
            after = _counts.launch_counts()
            # the capture recorded launches without running them
            self.delta[average] = {k: n - before[k] for k, n in after.items()
                                   if n != before[k]}
            _counts.add_launches({k: -n for k, n in
                                  self.delta[average].items()})
            self.graphs[average] = graph
        torch.cuda.synchronize(dev)
        self.compile_s = time.perf_counter() - t0

    def __call__(self, state, img, lbl, key, epoch_offset: int = 0):
        b = self._check(img)
        if self.static is None:
            self.static = state
        elif state is not self.static:
            _copy_state(self.static, state)
        for e in range(self.num_epochs):
            epoch = epoch_offset + e
            self._shuffle(img, lbl, key, epoch)
            if self.graphs is None:
                self._capture(img, lbl, b)
            if e == 0:
                self._i.zero_()
            for i in range(self.spe):
                average = self._syncs(epoch * self.spe + i)
                self.graphs[average].replay()
                _counts.add_launches(self.delta[average])
        shape = (self.num_epochs, self.spe)
        return (self.static, self._costs.view(shape).clone(),
                self._accs.view(shape).clone())


# a captured epoch over a gloo group (gloo stages its collectives through
# the host, which a CUDA graph cannot record)
GLOO_CAPTURE_REFUSED = (
    "the captured MLP epoch cannot run over a gloo process group on the "
    "card: a CUDA graph records no gloo collective (gloo stages CUDA "
    "tensors through the host); use NCCL, or take the host path with "
    "--no_fast_loop")


def build_run_to_completion(cfg, spec, optimizer, steps_per_epoch: int,
                            num_epochs: int, device,
                            body: Optional[Callable] = None,
                            sync_period: int = 0, mesh=None) -> Callable:
    """The whole run on the device: ``(state, images, labels, key,
    epoch_offset=0) -> (state, costs [E, spe], accs [E, spe])``, the
    step captured in a CUDA graph where ``captures(spec, device)``
    (raises ``GLOO_CAPTURE_REFUSED`` when the mesh's groups are gloo's).
    ``body``: the step (default the synchronous one over ``mesh``;
    FSDP's, or local SGD's with ``sync_period`` K)."""
    mesh = mesh if mesh is not None else mesh_lib.build_mesh(-1)
    captured = captures(spec, device)
    if captured and mesh_lib.uses_gloo(mesh):
        raise ValueError(GLOO_CAPTURE_REFUSED)
    cls = _GraphRunner if captured else _EagerRunner
    return cls(cfg, spec, optimizer, steps_per_epoch, num_epochs, body=body,
               sync_period=sync_period, mesh=mesh)


def build_epoch_runner(cfg, spec, optimizer, steps_per_epoch: int,
                       device, body: Optional[Callable] = None,
                       mesh=None) -> Callable:
    """One epoch a call, for host control between epochs (periodic
    checkpoints): ``(state, images, labels, key, epoch) -> (state,
    costs [spe], accs [spe])``."""
    run1 = build_run_to_completion(cfg, spec, optimizer, steps_per_epoch,
                                   1, device, body=body, mesh=mesh)

    def runner(state, img, lbl, key, epoch: int):
        state, costs, accs = run1(state, img, lbl, key, epoch)
        return state, costs[0], accs[0]

    runner.run1 = run1
    return runner


def build_fast_eval(cfg, spec, images: np.ndarray, labels: np.ndarray,
                    device, dp: int = 1, rank: int = 0,
                    mesh=None) -> Callable:
    """The test split staged on ``device`` once — packed, zero-padded to
    whole chunks of ``min(eval_chunk_cap(spec, n), n)`` examples rounded
    up to a multiple of ``dp``, the padding masked, data index ``rank``
    holding its ``chunk / dp`` rows of each chunk as JAX's devices of
    that data index do — and ``params -> accuracy`` over it (this rank's
    shards under the ``mesh``'s TP), the count summed over the data
    group, with one fetch.  ``.dispatch(params)`` returns the correct count as
    a device scalar without fetching it; ``.n`` is the example count."""
    n = images.shape[0]
    chunk = -(-max(1, min(step_lib.eval_chunk_cap(spec, n), n)) // dp) * dp
    n_pad = -(-n // chunk) * chunk
    packed = pack_images(images)
    img = np.zeros((n_pad, images.shape[1]), packed.dtype)
    img[:n] = packed
    lbl = np.zeros((n_pad, labels.shape[1]), np.float32)
    lbl[:n] = labels
    mask = (np.arange(n_pad) < n).astype(np.float32)
    local = chunk // dp

    def rank_rows(a):
        """This rank's ``local`` rows of every chunk, in order."""
        blocks = a.reshape(n_pad // chunk, dp, local, *a.shape[1:])
        return np.ascontiguousarray(blocks[:, rank].reshape(
            -1, *a.shape[1:]))

    img_d = torch.from_numpy(rank_rows(img)).to(device)
    lbl_d = torch.from_numpy(rank_rows(lbl)).to(device)
    mask_d = torch.from_numpy(rank_rows(mask)).to(device)
    divisor = _divisor(img_d.device)
    mesh = mesh if mesh is not None else mesh_lib.build_mesh(-1)
    eval_step = step_lib.build_eval_step(cfg, spec, reduce=False, mesh=mesh)

    def dispatch(params) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=img_d.device)
        for off in range(0, img_d.shape[0], local):
            sl = slice(off, off + local)
            total += eval_step(params, normalize(img_d[sl], divisor),
                               lbl_d[sl], mask_d[sl])
        mesh_lib.data_all_reduce(total, mesh)
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
