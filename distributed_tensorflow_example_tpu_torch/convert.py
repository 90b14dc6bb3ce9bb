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
- ``pipeline_params_from_numpy(np_params, spec, device)``: the JAX
  package's stacked pipeline params (``blk_*`` leaves ``[num_blocks,
  ...]`` beside the embedding and head leaves, as numpy) -> the port's,
  checked against ``transformer.pipeline_param_shapes``;
  ``stack_numpy(np_params, spec, stages, virtual)`` and
  ``unstack_numpy(...)`` carry a flat or stacked numpy tree (params or
  one optimizer slot tree) into the other layout at ``(stages,
  virtual)``, as JAX's ``pipeline_stack_params`` /
  ``pipeline_unstack_params`` do, so a JAX pipeline checkpoint's leaves
  and the port's cross in either direction.
- ``expert_shard(params, spec, expert_parallel, expert_index)``: whole
  params with each MoE block's expert leaves cut to one rank's experts
  (the block of JAX's ``P('expert')`` that device r holds).
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
from .resilience.codec import decode_array


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor; bf16 arrays (ml_dtypes, whose
    dtype numpy names "bfloat16") go through their 16-bit pattern."""
    return decode_array(a)


def _decode_leaf(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A checkpoint leaf saved in a bit container (bf16 is stored as
    uint16 with its dtype name beside it) back to a tensor of that
    dtype (``resilience/codec.decode_array``)."""
    return decode_array(a, dtype_name)


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


def pipeline_params_from_numpy(np_params: Dict[str, np.ndarray],
                               spec: tfm.TransformerSpec,
                               device: DeviceLike = None) -> tfm.Params:
    """The JAX package's stacked pipeline params as numpy (``blk_*``
    leaves ``[num_blocks, ...]``) as the port's, in ``spec.param_dtype``
    on ``device``."""
    return _params_from_numpy(np_params, tfm.pipeline_param_shapes(spec),
                              spec.param_dtype, device)


def stack_numpy(np_tree: Dict[str, np.ndarray], spec: tfm.TransformerSpec,
                stages: int = 1, virtual: int = 1) -> Dict[str, np.ndarray]:
    """A flat ``{name: array}`` tree (params, or one slot tree of the
    same names) in the stacked layout at ``(stages, virtual)``: JAX's
    ``pipeline_stack_params`` on numpy."""
    order = tfm._pipeline_block_order(spec.num_blocks, stages, virtual)
    out = {k: v for k, v in np_tree.items() if not k.startswith("L")}
    for leaf in tfm._block_leaf_names(spec):
        out[f"blk_{leaf}"] = np.stack([np.asarray(np_tree[f"L{j}_{leaf}"])
                                       for j in order])
    return out


def unstack_numpy(np_tree: Dict[str, np.ndarray],
                  spec: tfm.TransformerSpec, stages: int = 1,
                  virtual: int = 1) -> Dict[str, np.ndarray]:
    """The inverse of ``stack_numpy`` at the same ``(stages, virtual)``
    (JAX's ``pipeline_unstack_params`` on numpy)."""
    order = tfm._pipeline_block_order(spec.num_blocks, stages, virtual)
    out = {k: v for k, v in np_tree.items() if not k.startswith("blk_")}
    for leaf in tfm._block_leaf_names(spec):
        stacked = np.asarray(np_tree[f"blk_{leaf}"])
        for pos, j in enumerate(order):
            out[f"L{j}_{leaf}"] = stacked[pos]
    return out


def expert_shard(params: tfm.Params, spec: tfm.TransformerSpec,
                 expert_parallel: int, expert_index: int) -> tfm.Params:
    """``params`` with every expert leaf (``tfm.expert_leaves``) cut to
    experts ``[index * E / ep, (index + 1) * E / ep)`` on dim 0 (copies);
    the router and the other leaves as they are."""
    expert = set(tfm.expert_leaves(spec))
    return {k: (v.chunk(expert_parallel, dim=0)[expert_index].clone()
                if k in expert else v) for k, v in params.items()}


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
           "mlp_params_from_numpy", "pipeline_params_from_numpy",
           "stack_numpy", "unstack_numpy", "expert_shard",
           "train_state_from_checkpoint"]
