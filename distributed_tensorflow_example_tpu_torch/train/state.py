"""The train state: the step counter, the params and the optimizer slots
(the JAX package's ``train/state.py``, as a plain dataclass of tensors
and dicts of tensors)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor      # global_step, an int32 scalar
    params: Any             # {W1, b1, ...}
    opt_state: Any          # the optimizer's slots (``()`` for SGD)


def create_train_state(spec, optimizer, seed: int = 1,
                       device: DeviceLike = None) -> TrainState:
    """The seeded init (``models.mlp.init``) and its optimizer state on
    ``device``.  Only the MLP family trains in the port so far."""
    from ..models import mlp

    if not isinstance(spec, mlp.MLPSpec):
        raise NotImplementedError(
            "training the transformer family is not ported yet "
            "(ROADMAP.md Queue A, slice 3)")
    dev = resolve_device(device)
    params = mlp.init(spec, seed=seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=optimizer.init(params))
