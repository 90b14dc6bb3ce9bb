"""Carry weights from the JAX package into the port.

- ``params_from_numpy(np_params, spec, device)``: the JAX package's
  params given as numpy arrays (``{name: np.ndarray}``, e.g.
  ``{k: np.asarray(v) for k, v in tfm.init(key, spec).items()}``) ->
  the port's params.  Names and layouts are the same on both sides
  (``Wqkv`` is ``[d, 3, d]``), so this checks names and shapes, casts
  to ``spec.param_dtype`` and places the tensors on ``device``.
- ``params_from_checkpoint(path, spec, device)``: the params out of a
  JAX training checkpoint ``.npz`` (a file, or the newest
  ``ckpt-*.npz`` under a directory), found the way the JAX
  ``dtx-serve`` finds them: by the tail of each saved tree path, with
  bf16 leaves decoded from their 16-bit containers.
- ``mlp_params_from_numpy(np_params, spec, device)``: the same as
  ``params_from_numpy`` for an ``MLPSpec`` (``{W1, b1, ...}``).
- ``train_state_from_checkpoint(path, spec, optimizer, device)``: a
  whole training state (step, params, optimizer slots) of either
  family (an ``MLPSpec`` or a ``TransformerSpec``) out of a JAX
  training checkpoint, the keys matched exactly
  (``utils/checkpoint.restore_checkpoint``).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import mlp
from .models import transformer as tfm


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor; bf16 arrays (ml_dtypes, whose
    dtype numpy names "bfloat16") go through their 16-bit pattern."""
    a = np.array(a)      # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _decode_leaf(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A checkpoint leaf saved in a bit container (the JAX package's
    ``utils/checkpoint._decode_leaf``: bf16 is stored as uint16 with its
    dtype name beside it) back to a tensor of that dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return _to_tensor(a.view(np.dtype(dtype_name)))


def _params_from_numpy(np_params, expect: Dict[str, Tuple[int, ...]],
                       param_dtype, device: DeviceLike):
    dev = resolve_device(device)
    missing = sorted(set(expect) - set(np_params))
    extra = sorted(set(np_params) - set(expect))
    if missing or extra:
        raise ValueError(f"params do not match the spec: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for name, shape in expect.items():
        t = np_params[name]
        t = t if isinstance(t, torch.Tensor) else _to_tensor(t)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        out[name] = t.to(device=dev, dtype=param_dtype)
    return out


def params_from_numpy(np_params: Dict[str, np.ndarray],
                      spec: tfm.TransformerSpec,
                      device: DeviceLike = None) -> tfm.Params:
    """The JAX package's numpy params as the port's params (same names
    and layouts) in ``spec.param_dtype`` on ``device``."""
    return _params_from_numpy(np_params, tfm.param_shapes(spec),
                              spec.param_dtype, device)


def mlp_params_from_numpy(np_params: Dict[str, np.ndarray],
                          spec: mlp.MLPSpec,
                          device: DeviceLike = None) -> mlp.Params:
    """The JAX package's MLP params (``{W1: [s0, s1], b1: [s1], ...}`` as
    numpy) as the port's, in ``spec.param_dtype`` on ``device``."""
    return _params_from_numpy(np_params, mlp.param_shapes(spec),
                              spec.param_dtype, device)


def train_state_from_checkpoint(path: str, spec, optimizer,
                                device: DeviceLike = None):
    """``(TrainState, step, epoch)`` from a JAX training checkpoint (a
    ``.npz``, or the newest ``ckpt-*.npz`` under a directory) written
    for ``spec`` (an ``MLPSpec`` or a ``TransformerSpec``) with
    ``optimizer``'s slots, e.g. Adam's bf16 moments."""
    from .train.state import create_train_state
    from .utils.checkpoint import latest_checkpoint, restore_checkpoint

    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no ckpt-*.npz under {path}")
        path = found
    template = create_train_state(spec, optimizer, device=device)
    return restore_checkpoint(path, template)


def params_from_checkpoint(path: str, spec: tfm.TransformerSpec,
                           device: DeviceLike = None
                           ) -> Tuple[tfm.Params, str]:
    """``(params, the .npz read)`` from a JAX training checkpoint.
    Each expected param name is matched against the flattened key
    tails, shape-checked; keys under a ``params`` path win over
    optimizer slots of the same name and shape."""
    if os.path.isdir(path):
        cands = sorted(glob.glob(os.path.join(path, "ckpt-*.npz")))
        if not cands:
            raise FileNotFoundError(f"no ckpt-*.npz under {path}")
        path = cands[-1]
    expect = tfm.param_shapes(spec)
    found = {}
    with np.load(path) as z:
        dts = {m.group(1): str(z[k][()])
               for k in z.files
               for m in [re.fullmatch(r"__dt_(.+)__", k)] if m}
        ordered = sorted((k for k in z.files if not k.startswith("__")),
                         key=lambda k: (0 if "params" in k else 1, k))
        for k in ordered:
            tail = k.split("/")[-1]
            if tail in expect and tuple(z[k].shape) == expect[tail] \
                    and tail not in found:
                a = z[k]
                found[tail] = (_decode_leaf(a, dts[k]) if k in dts
                               else _to_tensor(a))
    missing = sorted(set(expect) - set(found))
    if missing:
        raise ValueError(f"{path}: checkpoint lacks params {missing} "
                         f"(wrong model flags for this checkpoint?)")
    return params_from_numpy(found, spec, device), path


__all__ = ["params_from_numpy", "params_from_checkpoint",
           "mlp_params_from_numpy", "train_state_from_checkpoint"]
