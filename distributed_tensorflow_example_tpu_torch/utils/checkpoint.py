"""Classic checkpoints in the JAX package's two on-disk formats, for the
port's ``TrainState``, so a checkpoint moves either way between the
packages.

Keys are the JAX package's tree paths: ``.step``, ``.params/W1``,
``.opt_state/mu/W1``, ``.opt_state/inner/count`` ...  bf16 and fp8 leaves
are stored in same-width unsigned-int bit containers beside their dtype
name (``resilience/codec.py``, the one codec of every format).

- **Single file** ``ckpt-N.npz`` (the default): the full tree, written
  by the chief, plus ``__step__``/``__epoch__``, an ``__dt_<key>__``
  entry naming the dtype of each bit-encoded leaf and ``__x_<name>__``
  scalars of the training loop.
- **Sharded directory** ``ckpt-N.shards/`` (``--sharded_checkpoints``):
  every process writes only its own shards to ``proc-NNNNN.npz`` (each
  entry the shard's data and its global index bounds; the port's state
  is replicated, so process 0 writes every leaf whole and the others
  empty files), and the chief writes ``manifest.json`` naming every
  expected shard file.  A checkpoint is complete when the manifest and
  every file it names exist (all writes atomic tmp+rename), so a kill
  mid-save leaves an ignorable partial directory.  The restore
  reassembles the logical arrays from the index bounds, whatever number
  of processes wrote them, so a checkpoint the JAX package wrote at any
  topology restores here.  With ``--async_checkpoints`` the
  device-to-host copies stay synchronous and the file writes move to a
  background thread (``wait_for_pending_saves`` joins it and re-raises
  its failure).

Under the parallel strategies a rank holds a **block** of some global
leaves (a ``Layout`` over the ``('data', 'model')`` or the ``('site',
'data')`` mesh names them, ``Block`` by ``Block``): a row of a ``[dp,
...]`` leaf (ZeRO-1's optimizer slots, FSDP's flat shards, local SGD's
replicas), a row of an ``[mp, dp, ...]`` one (FSDP x TP, ZeRO-1's slots
of a leaf split under TP) or an ``[ep, dp, ...]`` one (ZeRO-1's slots of
an expert leaf), a row of a ``[sites, ...]`` one (multi-site training's
params, inner slots and error-feedback residual), a Megatron slice of a
leaf split over the model axis, or an expert leaf's slice of the
experts (dim 0 over the expert axis); under pipeline parallelism a
stacked ``blk_*`` leaf's slice of the blocks (dim 0 over the 'stage'
axis) with, beside it, an inner dim over the model axis or dim 1 over
the expert axis, and ZeRO-1's slots of it ``[pp, (mp | ep,) dp,
chunk]``.  The
sharded format has one rank per distinct block write it with its global
bounds (as JAX writes each device's shard), so JAX's
``restore_sharded_arrays`` reassembles the global leaf; ``gather_global``
all-gathers the blocks over the group that holds them for the chief's
single file, and ``take_local`` picks this rank's block of a restored
global leaf.

``--resume`` (``train/loop.py``) restores the newest complete checkpoint
of either format with ``latest_checkpoint`` and ``restore_checkpoint``;
``--resume=auto`` restores from the resilience store
(``resilience/``) through ``rebuild_tree_validated``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import cluster
from ..resilience.codec import (decode_array, dtype_name, encode_array,
                                torch_dtype)
from ..resilience.manifest import tiles_exactly
from ..train.state import TrainState


def _walk(tree: Any, prefix: str):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def flatten_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """``{key: tensor}`` with the JAX package's key strings (the dataclass
    fields as ``.step``/``.params``/``.opt_state``, dict keys joined by
    ``/``)."""
    out = {".step": state.step}
    for field in ("params", "opt_state"):
        for k, v in _walk(getattr(state, field), ""):
            out[f".{field}{k}"] = v
    return out


def map_state(fn, state: TrainState) -> TrainState:
    """``state`` with every leaf replaced by ``fn(key, leaf)``, ``key``
    its ``flatten_state`` key (the step's ``.step``)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, f"{prefix}/{i}")
                              for i, v in enumerate(tree))
        return fn(prefix, tree)

    return TrainState(fn(".step", state.step),
                      walk(state.params, ".params"),
                      walk(state.opt_state, ".opt_state"))


def save_checkpoint(ckpt_dir: str, state, step: int, epoch: int,
                    extras: dict | None = None) -> str:
    """Write ``ckpt-<step:08d>.npz`` atomically; returns its path.
    ``state``: a ``TrainState`` or its ``{key: tensor}`` leaves (a
    gathered global layout)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt-{step:08d}.npz")
    tmp = path + ".tmp.npz"
    payload = {}
    leaves = state if isinstance(state, dict) else flatten_state(state)
    for k, v in leaves.items():
        enc, name = encode_array(v)
        payload[k] = enc
        if name:
            payload[f"__dt_{k}__"] = np.asarray(name)
    payload["__step__"] = np.asarray(step, np.int64)
    payload["__epoch__"] = np.asarray(epoch, np.int64)
    for k, v in (extras or {}).items():
        payload[f"__x_{k}__"] = np.asarray(v)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_extras(path: str) -> dict:
    """The ``extras`` scalars a checkpoint of either format carries."""
    if os.path.isdir(path):
        with open(os.path.join(path, "manifest.json")) as f:
            return dict(json.load(f).get("extras", {}))
    out = {}
    with np.load(path) as z:
        for k in z.files:
            m = re.fullmatch(r"__x_(.+)__", k)
            if m:
                out[m.group(1)] = z[k].item()
    return out


def _sharded_complete(path: str) -> bool:
    """A sharded checkpoint directory is complete when its manifest
    exists and names only files that exist."""
    man = os.path.join(path, "manifest.json")
    if not os.path.isfile(man):
        return False
    try:
        with open(man) as f:
            manifest = json.load(f)
        return all(os.path.isfile(os.path.join(path, name))
                   for name in manifest["files"])
    except (OSError, ValueError, KeyError):
        return False


def _list_checkpoints(ckpt_dir: str) -> list:
    """``(step, name)`` of every complete checkpoint (single file or a
    complete sharded directory), by step; temporary files and
    incomplete directories never list."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt-(\d+)\.npz", name)
        if m:
            found.append((int(m.group(1)), name))
            continue
        m = re.fullmatch(r"ckpt-(\d+)\.shards", name)
        if m and _sharded_complete(os.path.join(ckpt_dir, name)):
            found.append((int(m.group(1)), name))
    return sorted(found)


def prune_checkpoints(ckpt_dir: str, keep: int) -> list:
    """Delete all but the ``keep`` newest complete checkpoints (0 = keep
    all); returns the deleted paths.  A sharded checkpoint still landing
    is not listed and does not count toward ``keep``: the disk holds
    keep + 1 until the next prune, never fewer than ``keep`` durable
    ones."""
    if keep <= 0:
        return []
    deleted = []
    for _, name in _list_checkpoints(ckpt_dir)[:-keep]:
        path = os.path.join(ckpt_dir, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)
        deleted.append(path)
    return deleted


def latest_checkpoint(ckpt_dir: str) -> str | None:
    found = _list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1][1]) if found else None


# ---- the sharded format ----

_PENDING_SAVES: list = []


def wait_for_pending_saves() -> None:
    """Join the background checkpoint writers (``--async_checkpoints``).
    Called before the next save and at the end of a run, so at most one
    write is in flight; a writer that failed re-raises here."""
    while _PENDING_SAVES:
        t = _PENDING_SAVES.pop()
        t.join()
        err = getattr(t, "error", None)
        if err is not None:
            raise RuntimeError(
                f"background checkpoint write failed: {err!r}") from err


def _bounds(shape) -> np.ndarray:
    """The index bounds ``[[0, d] per dim]`` of a whole leaf."""
    return np.asarray([[0, int(d)] for d in shape],
                      np.int64).reshape(-1, 2)


@dataclasses.dataclass(frozen=True)
class Block:
    """Where a rank's leaf sits in its global leaf: ``lead`` names the
    mesh axes of the global leaf's leading dims (each the axis's size,
    the local leaf at the rank's index there), ``split`` the local dim
    that is a slice of a global dim split over the mesh axis ``axis``
    (the model axis, or the expert axis for an expert leaf's dim 0),
    ``stage_split`` a local dim split over the 'stage' axis too (dim 0
    of a stacked ``blk_*`` leaf)."""
    lead: Tuple[str, ...] = ()
    split: Optional[int] = None
    axis: str = "model"
    stage_split: Optional[int] = None

    @property
    def splits(self) -> list:
        """``[(local dim, mesh axis)]`` of every split dim."""
        out = [] if self.split is None else [(self.split, self.axis)]
        if self.stage_split is not None:
            out.append((self.stage_split, "stage"))
        return out

    @property
    def varies(self) -> frozenset:
        """The mesh axes along which the ranks' blocks differ."""
        return frozenset(self.lead) | frozenset(a for _, a in self.splits)


class Layout:
    """The global layout of a strategy's state over a mesh
    (``parallel/mesh.Mesh``, with a 'site' axis outermost under
    multi-site training, a 'stage' axis after 'data' under pipeline
    parallelism, and a 'seq' axis, over which every leaf is replicated,
    or an 'expert' axis before 'model' under sequence or expert
    parallelism): ``block(key, leaf)`` -> the leaf's ``Block`` or None
    (replicated: every rank holds the whole leaf)."""

    def __init__(self, mesh, block: Callable):
        self.mesh = mesh
        self.block = block

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s index along each mesh axis."""
        m = self.mesh
        mid = m.sp * m.ep * m.mp
        inner = m.pp * mid
        return {"site": rank // (m.dp * inner),
                "data": (rank % (m.dp * inner)) // inner,
                "stage": (rank // mid) % m.pp,
                "seq": (rank // m.mp) % m.sp,
                "expert": (rank // m.mp) % m.ep, "model": rank % m.mp}

    def _size(self, axis: str) -> int:
        return {"site": self.mesh.sites, "data": self.mesh.dp,
                "stage": self.mesh.pp, "seq": self.mesh.sp,
                "expert": self.mesh.ep, "model": self.mesh.mp}[axis]

    def _rank(self, **at) -> int:
        """The rank at the coordinates ``at`` names, at this rank's
        index along every other axis (a block that does not vary over an
        axis is tiled by the ranks of one index there)."""
        m = self.mesh
        c = dict(self.coords(m.rank), **at)
        return (((((c["site"] * m.dp + c["data"]) * m.pp + c["stage"])
                  * m.sp + c["seq"]) * m.ep + c["expert"]) * m.mp
                + c["model"])

    def global_shape(self, b: Block, shape) -> list:
        out = [int(d) for d in shape]
        for dim, axis in b.splits:
            out[dim] *= self._size(axis)
        return [self._size(ax) for ax in b.lead] + out

    def bounds(self, b: Block, shape, rank: int) -> np.ndarray:
        """The global bounds of ``rank``'s block of a leaf of local
        ``shape``."""
        idx = self.coords(rank)
        rows = [[idx[ax], idx[ax] + 1] for ax in b.lead]
        split = dict(b.splits)
        for i, n in enumerate(shape):
            lo = idx[split[i]] * int(n) if i in split else 0
            rows.append([lo, lo + int(n)])
        return np.asarray(rows, np.int64).reshape(-1, 2)

    def writes(self, b: Optional[Block], rank: int) -> bool:
        """Whether ``rank`` writes its block: the first rank holding it
        (index 0 along every axis the block does not vary over)."""
        if b is None:
            return rank == 0
        return all(i == 0 or ax in b.varies
                   for ax, i in self.coords(rank).items())

    def members(self, b: Block) -> Tuple[list, object]:
        """``(ranks, group)``: the ranks whose blocks tile the leaf
        together with this rank's, in the group's rank order, and the
        group an all-gather over them runs on (None: this rank alone)."""
        mesh = self.mesh
        for axis, group in (("model", mesh.model_group),
                            ("data", mesh.data_group),
                            ("site", mesh.site_group),
                            ("expert", mesh.expert_group),
                            ("stage", mesh.stage_group)):
            if b.varies == frozenset((axis,)):
                return ([self._rank(**{axis: i})
                         for i in range(self._size(axis))], group)
        group = None
        if any(g is not None for g in (mesh.data_group, mesh.site_group,
                                       mesh.expert_group,
                                       mesh.stage_group)):
            import torch.distributed as dist

            group = dist.group.WORLD
        return list(range(mesh.devices)), group


def local_shards(leaves: Dict[str, Any], layout: Optional[Layout] = None
                 ) -> Tuple[dict, dict]:
    """``(shards, leaf_meta)`` of this process's part of a checkpoint:
    each leaf of the ``layout`` that this rank writes as ``[(bounds,
    block)]`` within its global shape (recorded in ``leaf_meta``), every
    replicated leaf whole on process 0 only."""
    proc = cluster.process_index()
    shards, meta = {}, {}
    for key, leaf in leaves.items():
        b = layout.block(key, leaf) if layout is not None else None
        if b is None:
            if proc == 0:
                shards[key] = leaf
            continue
        meta[key] = {"shape": layout.global_shape(b, leaf.shape),
                     "dtype": dtype_name(leaf)}
        if layout.writes(b, proc):
            shards[key] = [(layout.bounds(b, leaf.shape, proc),
                            leaf.reshape((1,) * len(b.lead) + leaf.shape))]
    return shards, meta


def gather_global(state: TrainState, layout: Optional[Layout] = None
                  ) -> Dict[str, Any]:
    """``{key: tensor}`` of the state in its global layout, on every
    rank: each leaf of the ``layout`` all-gathered over the group whose
    blocks tile it (as raw bytes, so every dtype crosses gloo too) and
    placed by their bounds, the others as they are.  A collective: every
    rank calls it."""
    out = {}
    for key, leaf in flatten_state(state).items():
        b = layout.block(key, leaf) if layout is not None else None
        if b is None:
            out[key] = leaf
            continue
        ranks, group = layout.members(b)
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        flat = raw
        if group is not None:
            flat = raw.new_empty(len(ranks) * raw.numel())
            cluster.all_gather_flat(flat, raw, group=group)
        blocks = flat.view(leaf.dtype).reshape(len(ranks), *leaf.shape)
        full = leaf.new_zeros(layout.global_shape(b, leaf.shape))
        for r, blk in zip(ranks, blocks):
            idx = tuple(slice(int(lo), int(hi)) for lo, hi in
                        layout.bounds(b, leaf.shape, r))
            full[idx] = blk.reshape(full[idx].shape)
        out[key] = full
    return out


def take_local(data: Dict[str, Any], template: TrainState,
               layout: Optional[Layout] = None) -> Dict[str, Any]:
    """``data`` (a global-layout ``{key: tensor}``) with this rank's
    block of each leaf that ``template`` (this rank's local state) holds
    in the ``layout``."""
    out = dict(data)
    if layout is None:
        return out
    rank = layout.mesh.rank
    for key, leaf in flatten_state(template).items():
        b = layout.block(key, leaf)
        if b is not None:
            idx = tuple(slice(int(lo), int(hi)) for lo, hi in
                        layout.bounds(b, leaf.shape, rank))
            out[key] = data[key][idx].reshape(leaf.shape)
    return out


def save_checkpoint_sharded(ckpt_dir: str, state: TrainState, step: int,
                            epoch: int, extras: dict | None = None,
                            async_: bool = False,
                            on_complete=None, layout=None) -> str:
    """Every process calls this; no collective runs.  Each process writes
    its shard file atomically and the chief the manifest, so the
    checkpoint becomes visible to ``latest_checkpoint`` only once every
    process finished (several processes need a ``ckpt_dir`` they all
    share).  Each rank writes the blocks of the ``layout`` it is the
    first to hold, within their global shapes; process 0 also every
    replicated leaf.  The device-to-host copies happen here; under
    ``async_`` the file writes and ``on_complete`` (the retention prune)
    run on a background thread.  Returns the checkpoint directory."""
    wait_for_pending_saves()
    path = os.path.join(ckpt_dir, f"ckpt-{step:08d}.shards")
    os.makedirs(path, exist_ok=True)
    proc = cluster.process_index()
    nprocs = cluster.process_count()
    payload = {}
    leaves = flatten_state(state)
    shapes = {key: ([int(d) for d in leaf.shape], dtype_name(leaf))
              for key, leaf in leaves.items()}
    shards, meta = local_shards(leaves, layout)
    for key, m in meta.items():
        shapes[key] = (m["shape"], m["dtype"])
    for key, val in shards.items():
        pieces = val if isinstance(val, list) else [(_bounds(val.shape),
                                                     val)]
        for j, (bounds, data) in enumerate(pieces):
            payload[f"{key}§{j}"], _ = encode_array(data)
            payload[f"{key}§{j}§idx"] = bounds
    fname = f"proc-{proc:05d}.npz"

    def write():
        tmp = os.path.join(path, fname + f".tmp{os.getpid()}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, os.path.join(path, fname))
        if proc == 0:
            manifest = {
                "step": int(step), "epoch": int(epoch),
                "extras": {k: float(v) for k, v in (extras or {}).items()},
                "nprocs": int(nprocs),
                "files": [f"proc-{i:05d}.npz" for i in range(nprocs)],
                "leaves": {k: {"shape": s, "dtype": d}
                           for k, (s, d) in shapes.items()},
            }
            mtmp = os.path.join(path, f"manifest.tmp{os.getpid()}.json")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
            os.replace(mtmp, os.path.join(path, "manifest.json"))
        if on_complete is not None:
            on_complete()

    if async_:
        def guarded():
            try:
                write()
            except BaseException as e:  # surfaced by wait_for_pending
                t.error = e

        t = threading.Thread(target=guarded, daemon=False,
                             name=f"ckpt-writer-{step}")
        t.error = None
        t.start()
        _PENDING_SAVES.append(t)
    else:
        write()
    return path


def restore_sharded_arrays(path: str) -> Tuple[dict, int, int]:
    """``({key: CPU tensor}, step, epoch)`` reassembled from every shard
    file of a sharded checkpoint, each piece placed by the index bounds
    recorded at save time."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = {k: torch.zeros(tuple(v["shape"]), dtype=torch_dtype(v["dtype"]))
            for k, v in manifest["leaves"].items()}
    names = {k: v["dtype"] for k, v in manifest["leaves"].items()}
    boxes: Dict[str, list] = {k: [] for k in data}
    for name in manifest["files"]:
        with np.load(os.path.join(path, name)) as z:
            for entry in z.files:
                if entry.endswith("§idx"):
                    continue
                key, _j = entry.rsplit("§", 1)
                bounds = np.asarray(z[entry + "§idx"], np.int64)
                idx = tuple(slice(int(a), int(b)) for a, b in bounds)
                val = z[entry]
                data[key][idx] = decode_array(
                    val, names[key] if val.dtype.name != names[key]
                    else None)
                boxes[key].append(bounds.reshape(-1, 2))
    missing = [k for k, bs in boxes.items()
               if not tiles_exactly(bs, data[k].shape)]
    if missing:
        raise ValueError(
            f"sharded checkpoint {path} does not cover leaves "
            f"{missing[:5]} — saved by an incompatible writer?")
    return data, int(manifest["step"]), int(manifest["epoch"])


def _rebuild(tree: Any, prefix: str, data: dict, path: str) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}/{k}", data, path)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, f"{prefix}/{i}", data, path)
                          for i, v in enumerate(tree))
    if prefix not in data:
        raise KeyError(f"checkpoint {path} missing leaf {prefix!r}")
    t = data[prefix]
    if tuple(t.shape) != tuple(tree.shape):
        raise ValueError(f"checkpoint leaf {prefix!r} shape "
                         f"{tuple(t.shape)} != expected {tuple(tree.shape)}")
    # a meta template (FSDP's full shapes) keeps the data where it is
    dev = t.device if tree.device.type == "meta" else tree.device
    return t.to(device=dev, dtype=tree.dtype)


def rebuild_tree_validated(data: dict, template: TrainState,
                           ckpt_path: str = "<data>") -> TrainState:
    """``data`` (``{key: tensor}``) matched by key into ``template``'s
    structure, shape-checked, cast to its dtypes and placed on its
    devices: the one rebuild of every format and of the resilience
    store."""
    return TrainState(
        step=_rebuild(template.step, ".step", data, ckpt_path),
        params=_rebuild(template.params, ".params", data, ckpt_path),
        opt_state=_rebuild(template.opt_state, ".opt_state", data,
                           ckpt_path))


def restore_checkpoint(path: str, template: TrainState
                       ) -> Tuple[TrainState, int, int]:
    """``(state, step, epoch)`` from a checkpoint of either format (a
    ``.shards`` directory is reassembled first), rebuilt into
    ``template`` by ``rebuild_tree_validated``."""
    data, step, epoch = restore_arrays(path)
    return rebuild_tree_validated(data, template, path), step, epoch


def restore_arrays(path: str) -> Tuple[dict, int, int]:
    """``({key: CPU tensor}, step, epoch)``: the logical leaves of a
    checkpoint of either format."""
    if os.path.isdir(path):
        data, step, epoch = restore_sharded_arrays(path)
    else:
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
        step = int(raw.pop("__step__"))
        epoch = int(raw.pop("__epoch__"))
        dts = {k[len("__dt_"):-2]: str(raw.pop(k))
               for k in [k for k in raw if k.startswith("__dt_")]}
        data = {k: decode_array(v, dts.get(k))
                for k, v in raw.items() if not k.startswith("__")}
    return data, step, epoch
