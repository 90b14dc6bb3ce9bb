"""The content-addressed incremental snapshot store.

On-disk layout (all writes atomic tmp+rename)::

    <ckpt_dir>/
      objects/<digest>.npy            # one leaf (or leaf shard) payload
      snap-00000042.part00000.json    # per-process part manifest
      snap-00000042.json              # root manifest -- written LAST

Every leaf payload persists as an ``objects/`` file named by its
content digest (dtype + shape + bytes). A leaf whose content is
unchanged since a previous snapshot hashes to the same name and is
**never rewritten** — that is the "incremental" in incremental
checkpointing: consecutive snapshots share storage and IO for
everything that did not move (frozen embeddings, pre-first-sync
error-feedback residuals, the SIGTERM final snapshot when no step ran
since the last periodic one).

A snapshot becomes *visible* only when its root manifest lands — the
root is written last, after every object and part file, so a process
killed mid-save (kill -9 included) leaves an invisible partial
snapshot, never a corrupt resumable one. ``newest_valid_snapshot``
additionally re-verifies the closure (every part present, every
referenced object present) and walks back to the previous valid
snapshot when the newest is torn — the retention test pins this
fallback.

Retention (``prune_snapshots``): keep the newest K valid snapshots,
delete the rest's manifests, then garbage-collect every object no
remaining part manifest references. The GC scans *all* part manifests
present — including rootless ones (a peer's in-flight save) — and
spares objects younger than ``grace_s``, so a concurrent writer's
freshly-landed objects are never collected out from under it.

This is the port's copy of the JAX package's ``resilience/manifest.py``:
the layout, the object digests and the manifest keys are the JAX
package's byte for byte, so a store either package writes restores in
the other.  Snapshots are handed over as CPU tensors (or numpy arrays);
``restore_arrays`` returns CPU tensors.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .codec import decode_array, dtype_name, encode_array, torch_dtype

FORMAT = 1
OBJECTS_DIR = "objects"

_ROOT_RE = re.compile(r"snap-(\d{8})\.json$")
_PART_RE = re.compile(r"snap-(\d{8})\.part(\d{5})\.json$")


def root_name(step: int) -> str:
    return f"snap-{step:08d}.json"


def part_name(step: int, proc: int) -> str:
    return f"snap-{step:08d}.part{proc:05d}.json"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        # fsync BEFORE the rename: os.replace is metadata-only and can
        # become durable before the payload after a power loss, which
        # would leave a visible-but-torn object. Runs on the writer
        # thread, never on the step's critical path.
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    _atomic_write_bytes(path, json.dumps(doc).encode())


def object_digest(a: np.ndarray) -> str:
    """Content digest of an (already-encoded) payload array: dtype +
    shape + bytes. The digest IS the object filename stem, which is
    what makes unchanged leaves free across snapshots."""
    h = hashlib.sha1()
    h.update(a.dtype.name.encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:20]


def write_object(ckpt_dir: str, a: np.ndarray) -> Tuple[str, bool]:
    """Persist one payload array into the object store; returns
    (object name, wrote) — ``wrote`` False when the content already
    exists (the incremental reuse path, no IO beyond a stat)."""
    odir = os.path.join(ckpt_dir, OBJECTS_DIR)
    os.makedirs(odir, exist_ok=True)
    name = object_digest(a) + ".npy"
    path = os.path.join(odir, name)
    if os.path.exists(path):
        return name, False
    import io

    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    _atomic_write_bytes(path, buf.getvalue())
    return name, True


def write_part(ckpt_dir: str, step: int, proc: int,
               entries: Dict[str, List[Dict[str, Any]]]) -> str:
    """Persist one process's part manifest; returns its filename.
    ``entries``: key -> [{"object", "bounds" ([[lo,hi] per dim] or
    None = full leaf), "enc" (original dtype name when bit-encoded)}]
    — the objects must already be written."""
    name = part_name(step, proc)
    # a process that writes no object (its blocks all first held by
    # another rank) may get here before any process made the directory
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write_json(os.path.join(ckpt_dir, name),
                       {"format": FORMAT, "step": int(step),
                        "proc": int(proc), "entries": entries})
    return name


def write_root(ckpt_dir: str, step: int, epoch: int, nprocs: int,
               leaves: Dict[str, Dict[str, Any]],
               extras: Optional[Dict[str, Any]] = None,
               data_state: Optional[Dict[str, Any]] = None) -> str:
    """Persist the root manifest — the LAST write of a snapshot (the
    visibility/durability edge). ``leaves``: key -> {"shape",
    "dtype"} for the full (pre-shard) arrays."""
    path = os.path.join(ckpt_dir, root_name(step))
    _atomic_write_json(path, {
        "format": FORMAT, "step": int(step), "epoch": int(epoch),
        "t": time.time(), "nprocs": int(nprocs),
        "parts": [part_name(step, p) for p in range(nprocs)],
        "leaves": leaves,
        "extras": dict(extras or {}),
        "data_state": dict(data_state or {}),
    })
    return path


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def list_snapshots(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(step, root filename) for every snapshot whose ROOT landed,
    step-sorted. Visibility only — validity is ``snapshot_valid``."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _ROOT_RE.fullmatch(name)
        if m:
            found.append((int(m.group(1)), name))
    return sorted(found)


def _part_objects(part: Dict[str, Any]) -> Iterable[str]:
    for recs in (part.get("entries") or {}).values():
        for rec in recs:
            obj = rec.get("object")
            if obj:
                yield obj


def snapshot_valid(ckpt_dir: str, manifest: Dict[str, Any]) -> bool:
    """A snapshot is valid iff every part manifest it names exists,
    parses, and every object any part references exists. (A torn
    object store — e.g. an object GC'd by an over-eager cleanup —
    must fail here, not deep inside restore.)"""
    try:
        for pname in manifest["parts"]:
            part = load_manifest(os.path.join(ckpt_dir, pname))
            for obj in _part_objects(part):
                if not os.path.isfile(
                        os.path.join(ckpt_dir, OBJECTS_DIR, obj)):
                    return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def newest_valid_snapshot(
        ckpt_dir: str) -> Optional[Tuple[Dict[str, Any], str]]:
    """(manifest, root path) of the newest snapshot whose full closure
    verifies — walking back past torn newer ones (the retention
    fallback) — or None when no valid snapshot exists."""
    for _step, name in reversed(list_snapshots(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        try:
            manifest = load_manifest(path)
        except (OSError, ValueError):
            continue
        if snapshot_valid(ckpt_dir, manifest):
            return manifest, path
    return None


def prune_snapshots(ckpt_dir: str, keep: int,
                    grace_s: float = 300.0) -> Dict[str, Any]:
    """Keep the newest ``keep`` VALID snapshots (0 = keep all; torn
    snapshots older than the newest kept are always deleted), then
    collect every object referenced by no remaining part manifest.
    Returns {"roots_deleted", "parts_deleted", "objects_deleted"}.

    The object GC scans ALL part manifests on disk — including parts
    whose root has not landed yet (a peer mid-save) — and spares
    objects modified within ``grace_s`` seconds, so a concurrent
    writer's objects-without-a-part-yet window is covered."""
    out = {"roots_deleted": 0, "parts_deleted": 0, "objects_deleted": 0}
    if keep <= 0:
        return out
    snaps = list_snapshots(ckpt_dir)
    validity = {}
    for step, name in snaps:
        try:
            validity[step] = snapshot_valid(
                ckpt_dir, load_manifest(os.path.join(ckpt_dir, name)))
        except (OSError, ValueError):
            validity[step] = False
    valid_steps = [s for s, _n in snaps if validity[s]]
    kept = set(valid_steps[-keep:])
    # a snapshot NEWER than the newest kept valid one that fails the
    # closure check is (in a multi-process run) most likely still
    # LANDING — peer part files in flight. Deleting it would destroy
    # a checkpoint mid-save; over-retention is the safe direction
    # (the classic sharded format's prune makes the same call), so
    # only snapshots older than the kept horizon are eligible.
    horizon = max(kept) if kept else -1
    for step, name in snaps:
        if step in kept or step > horizon:
            continue
        try:
            os.remove(os.path.join(ckpt_dir, name))
            out["roots_deleted"] += 1
        except OSError:
            pass
    # parts whose step no longer has a (kept) root — same in-flight
    # protection: a part newer than the horizon may precede its root
    for path in glob.glob(os.path.join(ckpt_dir, "snap-*.part*.json")):
        m = _PART_RE.fullmatch(os.path.basename(path))
        if m is None or int(m.group(1)) in kept \
                or int(m.group(1)) > horizon:
            continue
        try:
            os.remove(path)
            out["parts_deleted"] += 1
        except OSError:
            pass
    # object GC against every part manifest still present
    live: set = set()
    for path in glob.glob(os.path.join(ckpt_dir, "snap-*.part*.json")):
        try:
            live |= set(_part_objects(load_manifest(path)))
        except (OSError, ValueError):
            continue
    now = time.time()
    for path in glob.glob(os.path.join(ckpt_dir, OBJECTS_DIR, "*.npy")):
        if os.path.basename(path) in live:
            continue
        try:
            if now - os.path.getmtime(path) < grace_s:
                continue
            os.remove(path)
            out["objects_deleted"] += 1
        except OSError:
            pass
    # orphaned atomic-write temps: a kill -9 between the tmp write
    # and the rename strands '<name>.tmp<pid>' files that match none
    # of the globs above — swept here (past the grace window) so a
    # long-lived checkpoint dir surviving many preemptions does not
    # accumulate them unboundedly
    for path in (glob.glob(os.path.join(ckpt_dir, OBJECTS_DIR,
                                        "*.tmp*"))
                 + glob.glob(os.path.join(ckpt_dir, "snap-*.tmp*"))):
        try:
            if now - os.path.getmtime(path) < grace_s:
                continue
            os.remove(path)
            out["objects_deleted"] += 1
        except OSError:
            pass
    return out


def tiles_exactly(bs: List[np.ndarray], shape) -> bool:
    """The index boxes ``bs`` (``[[lo, hi] per dim]`` each) tile a leaf of
    ``shape`` exactly: pairwise disjoint, their sizes summing to the
    leaf's, so an overlap can never mask a gap.  Near-linear for the
    dim-0 layouts the writers emit (a sweep on dim 0 prunes the pairs).
    Both stores' restores check their shards with it."""
    if any(len(b) != len(shape) for b in bs):
        return False
    total = sum(int(np.prod(b[:, 1] - b[:, 0])) if b.size else 1
                for b in bs)
    if total != int(np.prod(tuple(shape), dtype=np.int64)):
        return False
    if not len(shape):
        return len(bs) == 1
    bs = sorted(bs, key=lambda b: int(b[0, 0]))
    for i, a in enumerate(bs):
        for b in bs[i + 1:]:
            if b[0, 0] >= a[0, 1]:
                break                    # sorted: no later overlap
            if all((a[d, 1] > b[d, 0]) and (b[d, 1] > a[d, 0])
                   for d in range(len(a))):
                return False
    return True


def _load_object(ckpt_dir: str, name: str) -> np.ndarray:
    return np.load(os.path.join(ckpt_dir, OBJECTS_DIR, name),
                   allow_pickle=False)


def restore_arrays(ckpt_dir: str,
                   manifest: Dict[str, Any]
                   ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Reassemble a snapshot into full host arrays:
    ({tree-path key: CPU tensor}, step, epoch). Shard bounds recorded
    at save time place each piece, so the format is topology-agnostic
    (the utils/checkpoint sharded-format discipline); coverage is
    verified exactly — disjoint boxes whose sizes sum to the leaf."""
    leaves = manifest["leaves"]
    data = {k: torch.zeros(tuple(v["shape"]), dtype=torch_dtype(v["dtype"]))
            for k, v in leaves.items()}
    boxes: Dict[str, List[np.ndarray]] = {k: [] for k in data}
    for pname in manifest["parts"]:
        part = load_manifest(os.path.join(ckpt_dir, pname))
        for key, recs in (part.get("entries") or {}).items():
            if key not in data:
                raise ValueError(
                    f"part {pname} carries unknown leaf {key!r}")
            for rec in recs:
                val = decode_array(_load_object(ckpt_dir, rec["object"]),
                                   rec.get("enc"))
                bounds = rec.get("bounds")
                if bounds is None:
                    bounds = [[0, d] for d in data[key].shape]
                b = np.asarray(bounds, np.int64).reshape(-1, 2)
                idx = tuple(slice(int(lo), int(hi)) for lo, hi in b)
                data[key][idx] = val
                boxes[key].append(b)

    missing = [k for k, bs in boxes.items()
               if not tiles_exactly(bs, data[k].shape)]
    if missing:
        raise ValueError(
            f"snapshot step {manifest.get('step')} does not cover "
            f"leaves {missing[:5]} — saved by an incompatible writer?")
    return data, int(manifest["step"]), int(manifest["epoch"])


def persist_snapshot(ckpt_dir: str, step: int, epoch: int,
                     snapshot: Dict[str, Any], proc: int = 0,
                     nprocs: int = 1, is_chief: bool = True,
                     extras: Optional[Dict[str, Any]] = None,
                     data_state: Optional[Dict[str, Any]] = None,
                     leaf_meta: Optional[Dict[str, Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
    """Write one process's share of a snapshot (objects + part), and —
    on the chief — the root manifest that makes it visible. This is
    the synchronous core ``CheckpointWriter`` runs on its thread.

    ``snapshot``: key -> host tensor or array (the full leaf), or key ->
    [(bounds, shard), ...] for this process's shards of a
    larger leaf; every process must agree on the key set. Sharded
    leaves need ``leaf_meta[key] = {"shape", "dtype"}`` (the GLOBAL
    logical leaf — this process's shards may not span it). Returns
    write stats ({"objects_written", "objects_reused", "bytes_written",
    "root"})."""
    stats = {"objects_written": 0, "objects_reused": 0,
             "bytes_written": 0, "root": None}
    entries: Dict[str, List[Dict[str, Any]]] = {}
    leaves: Dict[str, Dict[str, Any]] = {}
    for key, val in snapshot.items():
        if isinstance(val, list):
            shards = [(np.asarray(b, np.int64).reshape(-1, 2).tolist(), a)
                      for b, a in val]
            meta = (leaf_meta or {}).get(key)
            if meta is None:
                raise ValueError(
                    f"sharded leaf {key!r} needs leaf_meta (the global "
                    f"shape/dtype — this process's shards may not span "
                    f"the logical leaf)")
            shape, dtype = list(meta["shape"]), str(meta["dtype"])
        else:
            shards = [(None, val)]
            shape, dtype = [int(d) for d in val.shape], dtype_name(val)
        leaves[key] = {"shape": shape, "dtype": dtype}
        recs = []
        for bounds, arr in shards:
            enc, enc_name = encode_array(arr)
            obj, wrote = write_object(ckpt_dir, enc)
            if wrote:
                stats["objects_written"] += 1
                stats["bytes_written"] += int(enc.nbytes)
            else:
                stats["objects_reused"] += 1
            recs.append({"object": obj, "bounds": bounds,
                         "enc": enc_name})
        entries[key] = recs
    write_part(ckpt_dir, step, proc, entries)
    if is_chief:
        stats["root"] = write_root(
            ckpt_dir, step, epoch, nprocs, leaves, extras=extras,
            data_state=data_state)
    return stats
