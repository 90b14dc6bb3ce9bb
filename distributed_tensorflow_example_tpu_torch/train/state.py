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
    params: Any             # {name: tensor} of the model family
    opt_state: Any          # the optimizer's slots (``()`` for SGD)


def create_train_state(spec, optimizer, seed: int = 1,
                       device: DeviceLike = None) -> TrainState:
    """The seeded init of either family (``models.mlp.init`` or
    ``models.transformer.init``) and its optimizer state on
    ``device``."""
    from ..models import mlp
    from ..models import transformer as tfm

    dev = resolve_device(device)
    if isinstance(spec, tfm.TransformerSpec):
        params = tfm.init(spec, seed=seed, device=dev)
    else:
        params = mlp.init(spec, seed=seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=optimizer.init(params))
