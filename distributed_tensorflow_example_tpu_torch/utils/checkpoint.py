"""Single-file ``.npz`` checkpoints in the JAX package's layout.

The JAX package saves its ``TrainState`` pytree as one ``.npz`` whose keys
are the tree paths: ``.step``, ``.params/W1``, ``.opt_state/mu/W1``,
``.opt_state/inner/count`` ..., plus ``__step__``/``__epoch__``, an
``__dt_<key>__`` entry naming the dtype of each leaf stored in a bit
container (bf16 as uint16, which ``np.savez`` can round-trip) and
``__x_<name>__`` scalars of the training loop.  This module writes and
reads the same files for the port's ``TrainState``, so a checkpoint
moves either way between the packages.  Writes are atomic (a temporary file, then a
rename).  The sharded format (``ckpt-N.shards/``) and ``--resume`` are
not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

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


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str | None]:
    """A tensor as a savable numpy array, plus its dtype name when it is
    stored in a bit container (bf16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int, epoch: int,
                    extras: dict | None = None) -> str:
    """Write ``ckpt-<step:08d>.npz`` atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt-{step:08d}.npz")
    tmp = path + ".tmp.npz"
    payload = {}
    for k, v in flatten_state(state).items():
        enc, name = _encode(v)
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
    """The ``extras`` scalars a checkpoint carries."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            m = re.fullmatch(r"__x_(.+)__", k)
            if m:
                out[m.group(1)] = z[k].item()
    return out


def _list_checkpoints(ckpt_dir: str) -> list:
    """``(step, filename)`` of every single-file checkpoint, by step."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt-(\d+)\.npz", name)
        if m:
            found.append((int(m.group(1)), name))
    return sorted(found)


def prune_checkpoints(ckpt_dir: str, keep: int) -> list:
    """Delete all but the ``keep`` newest checkpoints (0 = keep all);
    returns the deleted paths."""
    if keep <= 0:
        return []
    deleted = []
    for _, name in _list_checkpoints(ckpt_dir)[:-keep]:
        path = os.path.join(ckpt_dir, name)
        os.remove(path)
        deleted.append(path)
    return deleted


def latest_checkpoint(ckpt_dir: str) -> str | None:
    found = _list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1][1]) if found else None


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
    return t.to(device=tree.device, dtype=tree.dtype)


def restore_checkpoint(path: str, template: TrainState
                       ) -> Tuple[TrainState, int, int]:
    """``(state, step, epoch)``: the checkpoint's leaves matched by key
    into ``template``'s structure, shape-checked, cast to the template's
    dtypes and placed on its devices."""
    from ..convert import _decode_leaf, _to_tensor

    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    step = int(raw.pop("__step__"))
    epoch = int(raw.pop("__epoch__"))
    dts = {k[len("__dt_"):-2]: str(raw.pop(k))
           for k in [k for k in raw if k.startswith("__dt_")]}
    data = {k: (_decode_leaf(v, dts[k]) if k in dts else _to_tensor(v))
            for k, v in raw.items() if not k.startswith("__")}
    state = TrainState(
        step=_rebuild(template.step, ".step", data, path),
        params=_rebuild(template.params, ".params", data, path),
        opt_state=_rebuild(template.opt_state, ".opt_state", data, path))
    return state, step, epoch
