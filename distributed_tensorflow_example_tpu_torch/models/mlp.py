"""The activation table every model family shares.

Only ``_ACTIVATIONS`` is ported so far (the MLP itself comes with the
training slice).  ``jax.nn.gelu`` defaults to the tanh approximation,
so ``gelu`` here is ``F.gelu(x, approximate="tanh")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
